"""The ported slice end to end against fem_tpu and the reference goldens:
deck -> Problem -> System -> solve -> stress -> VTK, on the CPU."""

import os

import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import vtk
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic")
ELASTIC_DECK = os.path.join(ELASTIC, "elastic_test.inp")


def match_golden(problem, result, golden_path, disp_tol=1e-8,
                 stress_tol=1e-6):
    """tests/test_golden.py's comparison: per-rank golden VTK points matched
    to mesh nodes by coordinates."""
    pts, stress, disp = vtk.read_fields(golden_path)
    u = result.aggregate_u.reshape(problem.nnds, problem.pdim)
    for i in range(pts.shape[0]):
        p = pts[i, : problem.pdim]
        d = np.linalg.norm(problem.coords - p[None, :], axis=1)
        j = int(np.argmin(d))
        assert d[j] < 1e-9, f"golden point {p} not found in mesh"
        np.testing.assert_allclose(u[j], disp[i, : problem.pdim],
                                   atol=disp_tol)
        np.testing.assert_allclose(result.aggregate_stress[j], stress[i],
                                   atol=stress_tol)


@pytest.mark.parametrize("solver,bc_mode,path", [
    ("direct", "penalty", "direct"),
    ("direct", "eliminate", "direct"),
    ("cg", "eliminate", "unstructured_jacobi_cg"),
])
def test_elastic_golden(solver, bc_mode, path):
    problem = problem_mod.load(ELASTIC_DECK)
    result = stepper.run(problem, Config(device="cpu", solver=solver,
                                         bc_mode=bc_mode))
    assert result.nsteps == 10
    assert result.path == path
    match_golden(problem, result, os.path.join(ELASTIC, "0_output_000000.vtk"))
    match_golden(problem, result, os.path.join(ELASTIC, "1_output_000000.vtk"))


@pytest.mark.parametrize("args", [["--solver", "cg"], []],
                         ids=["cg", "default_direct_penalty"])
def test_cli_vtk_byte_identical_to_fem_tpu(tmp_path, monkeypatch, args):
    """The Jacobi-CG path does the same float64 operations in both packages
    and the files are byte-identical. The default dense-LU path factorizes
    with torch's LAPACK (MKL here) where fem_tpu uses scipy's (OpenBLAS):
    u differs in the last bit, which flips the sign of the ~1e-14 round-off
    left in the xy stress, so those files may differ only in "-.000000"
    against ".000000"."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert j_cli_main(["-f", ELASTIC_DECK, "-q", *args]) == 0
    monkeypatch.chdir(tmp_path / "torch")
    assert cli_main(["-f", ELASTIC_DECK, "--device", "cpu", "-q", *args]) == 0
    ours = (tmp_path / "torch" / "0_output_000000.vtk").read_bytes()
    ref = (tmp_path / "jax" / "0_output_000000.vtk").read_bytes()
    if args:
        assert ours == ref
    else:
        assert ours.replace(b"-.000000", b".000000") == ref.replace(
            b"-.000000", b".000000")
    pts, stress, disp = vtk.read_fields(
        str(tmp_path / "torch" / "0_output_000000.vtk"))
    top = pts[:, 1] == 2.0
    np.testing.assert_allclose(disp[top, 1], 0.1, atol=1e-12)
    np.testing.assert_allclose(stress[top][:, :2], [[105.0, 245.0]] * 2,
                               atol=1e-6)


def test_structured_box_matches_fem_tpu_mg_cg():
    """12^3 cells, 6,591 DOFs: above direct_threshold (so cg) and below
    fem_tpu's structured_big_threshold (so its float64 host-split MG-CG,
    the parity target for iteration counts)."""
    jp = j_meshgen.hex_box_problem(12, 12, 12, lx=1.0, ly=1.0, lz=1.0)
    assert jp.ndof == 6591
    jr = j_stepper.run(jp, JConfig())
    cuda_kernels.reset_launches()
    r = stepper.run(problem_mod.Problem.from_reference(jp),
                    Config(device="cpu"))
    assert r.path == "structured_mg_cg"
    assert r.krylov_iters == jr.krylov_iters
    for got, ref in ((r.aggregate_u, jr.aggregate_u),
                     (r.aggregate_stress, jr.aggregate_stress)):
        assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    # CPU tensors never launch a kernel
    assert cuda_kernels.launches == {"hex8_stiffness": 0,
                                     "hex8_stiffness_coord_grad": 0,
                                     "stencil_matvec": 0,
                                     "stencil_matvec_2d": 0, "csr_matvec": 0,
                                     "csr_data_grad": 0}
