"""Plane stress on the stencil rows, on the CPU in float64.

System substitutes E' = E(1+2nu)/(1+nu)^2, nu' = nu/(1+nu) for pdim 2
under Config.plane_stress, and the stencil of structured_mg_cg and
sharded_slab_stencil is built from that material (structured.operator_for).
fem_tpu's own structured row builds its stencil from the deck's (E, nu), so
on plane-stress boxes it solves the plane-strain K: the port is held here
against the direct rows of both packages, which assemble System's K.
Plane strain is held against fem_tpu's structured row in
test_torch_structured2d.py and test_torch_slice.py."""

import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen, vtk
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import structured
from fem_tpu_torch.ops.stiffness import lame
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

BOXES = [(16, 8), (24, 10)]
TIP = (0.0, -1e6)


def same(got, ref, tol=1e-8):
    """max |got - ref| <= tol * max |ref|, shapes equal."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


def boxes(nx, ny):
    """The clamped quad cantilever from fem_tpu's meshgen, and the port's
    Problem of it."""
    jp = j_meshgen.quad_grid_problem(nx, ny, tip_force=TIP)
    return jp, Problem.from_reference(jp)


def test_operator_for_takes_the_system_material():
    """The stencil's (lam, mu) are those of System's block: the substituted
    (E', nu') under plane stress, which fem_tpu's System holds too, and the
    deck's (E, nu) otherwise."""
    jp, p = boxes(4, 2)
    spec = structured.detect(p)
    E, nu = spec["E"], spec["nu"]
    for plane_stress, (E_s, nu_s) in (
            (False, (E, nu)),
            (True, (E * (1 + 2 * nu) / (1 + nu) ** 2, nu / (1 + nu)))):
        s = System(p, device="cpu", plane_stress=plane_stress)
        js = JSystem(jp, plane_stress=plane_stress)
        for key, value in (("E", E_s), ("nu", nu_s)):
            assert float(s.blocks["qua"][key][0]) == float(
                js.blocks["qua"][key][0])
            assert abs(float(s.blocks["qua"][key][0]) - value) <= 1e-15 * value
        op = structured.operator_for(s, spec)
        lam, mu = lame(torch.tensor(E_s, dtype=torch.float64),
                       torch.tensor(nu_s, dtype=torch.float64))
        assert abs(float(op.lam) - float(lam)) <= 1e-15 * float(lam)
        assert abs(float(op.mu) - float(mu)) <= 1e-15 * float(mu)
        assert op.shape == spec["node_shape"]


@pytest.mark.parametrize("nx,ny", BOXES, ids=["16x8", "24x10"])
def test_structured_mg_cg_matches_fem_tpu_direct(nx, ny):
    """structured_mg_cg under plane stress against fem_tpu's direct row
    under plane stress: u and nodal stress to 1e-8."""
    jp, p = boxes(nx, ny)
    jr = j_stepper.run(jp, JConfig(solver="direct", plane_stress=True))
    r = stepper.run(p, Config(device="cpu", solver="cg", plane_stress=True))
    assert r.path == "structured_mg_cg"
    assert same(r.aggregate_u, jr.aggregate_u)
    assert same(r.aggregate_stress, jr.aggregate_stress)


@pytest.mark.parametrize("nx,ny", BOXES, ids=["16x8", "24x10"])
def test_structured_mg_cg_matches_port_direct(nx, ny):
    """The same against the port's own direct row."""
    _, p = boxes(nx, ny)
    ref = stepper.run(p, Config(device="cpu", solver="direct",
                                plane_stress=True))
    r = stepper.run(p, Config(device="cpu", solver="cg", plane_stress=True))
    assert (ref.path, r.path) == ("direct", "structured_mg_cg")
    assert same(r.aggregate_u, ref.aggregate_u)
    assert same(r.aggregate_stress, ref.aggregate_stress)


@pytest.mark.parametrize("shards", [2, 3])
def test_slab_stencil_matches_fem_tpu_direct(shards):
    """sharded_slab_stencil under plane stress, 2 and 3 shards on the one
    CPU device, against fem_tpu's direct row: u and stress to 1e-8."""
    jp, p = boxes(16, 8)
    jr = j_stepper.run(jp, JConfig(solver="direct", plane_stress=True))
    r = stepper.run(p, Config(device="cpu", solver="cg", plane_stress=True,
                              n_devices=shards))
    assert r.path == "sharded_slab_stencil"
    assert same(r.aggregate_u, jr.aggregate_u)
    assert same(r.aggregate_stress, jr.aggregate_stress)


def test_strip_through_the_cli_matches_fem_tpu_direct(tmp_path, monkeypatch):
    """The reference's make_example strip (64 x 4 quads) through the port's
    CLI with --solver cg --plane-stress, which takes structured_mg_cg,
    against fem_tpu's CLI with --plane-stress --solver direct: the VTKs hold
    the same fields to 1e-8 of the largest."""
    deck = tmp_path / "strip.inp"
    deck.write_text(meshgen.quad_strip_deck(64, 4))
    paths = []
    run = stepper.run

    def recording(*args, **kw):
        res = run(*args, **kw)
        paths.append(res.path)
        return res

    monkeypatch.setattr(stepper, "run", recording)
    fields = {}
    for name, main, extra in (
            ("jax", j_cli_main, ["--solver", "direct"]),
            ("torch", cli_main, ["--solver", "cg", "--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(["-f", str(deck), "-q", "--plane-stress", *extra]) == 0
        fields[name] = vtk.read_fields(str(tmp_path / name
                                           / "0_output_000000.vtk"))
    assert paths == ["structured_mg_cg"]
    for got, ref in zip(fields["torch"], fields["jax"]):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-8 * max(np.abs(ref).max(), 1.0)


def test_3d_box_ignores_plane_stress():
    """System ignores plane_stress in 3D, and so does the stencil: the
    structured row's u is the same bits with and without it."""
    p = meshgen.hex_box_problem(4, 3, 2)
    runs = [stepper.run(p, Config(device="cpu", solver="cg",
                                  plane_stress=ps)) for ps in (False, True)]
    assert [r.path for r in runs] == ["structured_mg_cg"] * 2
    assert runs[0].krylov_iters == runs[1].krylov_iters
    np.testing.assert_array_equal(runs[1].aggregate_u, runs[0].aggregate_u)
    np.testing.assert_array_equal(runs[1].aggregate_stress,
                                  runs[0].aggregate_stress)
