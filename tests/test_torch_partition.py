"""fem_tpu_torch's per-shard mesh views and sharded VTK output
(parallel/partition.py, `--shards`) against fem_tpu's: local renumbering
covers every element exactly once, nl2g maps invert, the partition is
fem_tpu's on a seeded mesh, and every shard's VTK file equals fem_tpu's byte
for byte."""

import os

import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.io import native as j_native
from fem_tpu.parallel import partition as j_part
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen, native, vtk
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.parallel import partition as part_mod
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC_DECK = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic",
                            "elastic_test.inp")


def test_partition_covers_all_elements():
    problem = problem_mod.load(meshgen.quad_strip_deck(8, 4))
    epart = part_mod.partition(problem, 4)
    assert epart.shape == (32,)
    counts = np.bincount(epart, minlength=4)
    assert counts.sum() == 32
    assert counts.max() - counts.min() <= 1


def test_shard_meshes_roundtrip():
    problem = problem_mod.load(meshgen.quad_strip_deck(6, 3))
    epart = part_mod.partition(problem, 3)
    shards = part_mod.shard_meshes(problem, epart)
    assert sum(len(s.cells) for s in shards) == problem.nels
    for s in shards:
        # local conn indexes local coords; nl2g maps back to global coords
        for vtk_id, conn in s.cells:
            assert conn.min() >= 0 and conn.max() < s.nl2g.shape[0]
            np.testing.assert_allclose(s.coords[conn],
                                       problem.coords[s.nl2g[conn]])


def test_sharded_vtk_elastic(tmp_path):
    problem = problem_mod.load(ELASTIC_DECK)
    result = stepper.run(problem, Config(device="cpu"))
    paths = part_mod.write_sharded_vtk(
        problem, result.aggregate_stress, result.aggregate_u, 2,
        prefix=str(tmp_path) + "/")
    assert len(paths) == 2
    seen_cells = 0
    u = result.aggregate_u.reshape(problem.nnds, 2)
    for p in paths:
        pts, stress, disp = vtk.read_fields(p)
        seen_cells += sum(1 for line in open(p) if line.startswith("4 "))
        # every shard's fields agree with the global solution at matching
        # coordinates
        for i in range(pts.shape[0]):
            d = np.linalg.norm(problem.coords - pts[i, :2][None, :], axis=1)
            j = int(np.argmin(d))
            np.testing.assert_allclose(disp[i, :2], u[j], atol=1e-6)
            np.testing.assert_allclose(stress[i], result.aggregate_stress[j],
                                       atol=1e-6)
    assert seen_cells == problem.nels


def test_cli_shards_flag(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli_main(["-f", ELASTIC_DECK, "--device", "cpu", "-q",
                     "--shards", "2"]) == 0
    assert os.path.exists("0_output_000000.vtk")
    assert os.path.exists("1_output_000000.vtk")


def seeded_mesh():
    """A jittered 6 x 5 x 4 hex box (no two centroids tie) in both packages'
    Problem types."""
    jp = j_meshgen.hex_box_problem(6, 5, 4, jitter=0.25, seed=5)
    return Problem.from_reference(jp), jp


@pytest.mark.parametrize("method", ["rcb", "block"])
@pytest.mark.parametrize("nparts", [2, 3, 8])
def test_partition_matches_fem_tpu(method, nparts):
    p, jp = seeded_mesh()
    np.testing.assert_array_equal(part_mod.element_centroids(p),
                                  j_part.element_centroids(jp))
    got = part_mod.partition(p, nparts, method)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, j_part.partition(jp, nparts, method))
    with pytest.raises(ValueError, match="unknown partition method"):
        part_mod.partition(p, nparts, "metis")


@pytest.mark.parametrize("nparts", [2, 5, 8])
def test_numpy_rcb_matches_the_library(nparts, monkeypatch):
    """The numpy RCB that stands in when native/libfemmesh.so is not built
    gives the library's parts on a mesh without ties, and fem_tpu's Python
    fallback's."""
    assert native.available() and j_native.available()
    p, _ = seeded_mesh()
    cent = part_mod.element_centroids(p)
    lib = native.rcb_partition(cent, nparts)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    np.testing.assert_array_equal(native.rcb_partition(cent, nparts), lib)
    np.testing.assert_array_equal(part_mod.partition(p, nparts), lib)
    monkeypatch.setattr(j_native, "_load", lambda: None)
    np.testing.assert_array_equal(j_native.rcb_partition(cent, nparts), lib)


def test_cli_shard_vtks_byte_identical_to_fem_tpu(tmp_path, monkeypatch):
    """On the Jacobi-CG path both packages do the same float64 operations
    on the elastic golden deck (tests/test_torch_slice.py), so every shard's
    file is the same, byte for byte."""
    args = ["-f", ELASTIC_DECK, "-q", "--solver", "cg", "--precond", "jacobi",
            "--shards", "2"]
    for name, main, extra in (("jax", j_cli_main, []),
                              ("torch", cli_main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(args + extra) == 0
    for name in ("0_output_000000.vtk", "1_output_000000.vtk"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert not (tmp_path / "torch" / "2_output_000000.vtk").exists()


@pytest.mark.parametrize("method", ["rcb", "block"])
@pytest.mark.parametrize("nparts", [3, 8])
def test_sharded_vtk_byte_identical_on_seeded_fields(tmp_path, method,
                                                     nparts):
    """The same seeded nodal fields on the seeded 120-element mesh through
    both packages' write_sharded_vtk: every shard's file (its nodes, their
    renumbering, its cells and fields) is the same, byte for byte."""
    p, jp = seeded_mesh()
    rng = np.random.default_rng(11)
    stress = rng.standard_normal((p.nnds, 6)) * 1e3
    u = rng.standard_normal(p.ndof) * 1e-3
    ours = part_mod.write_sharded_vtk(p, stress, u, nparts, method=method,
                                      prefix=str(tmp_path) + "/t_", step=7)
    ref = j_part.write_sharded_vtk(jp, stress, u, nparts, method=method,
                                   prefix=str(tmp_path) + "/j_", step=7)
    assert [os.path.basename(f) for f in ours] == [
        f"t_{r}_output_000007.vtk" for r in range(nparts)]
    for a, b in zip(ours, ref):
        assert open(a, "rb").read() == open(b, "rb").read(), a
