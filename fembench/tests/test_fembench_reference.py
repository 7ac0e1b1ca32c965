"""The frozen generators against the program's, and the plain reference
against the port at sizes the CPU solves in seconds, through each cell's own
entry."""

import numpy as np
import pytest
import torch

from fembench import reference
from fembench.harness import compare, generators, spec
from fembench.reference import deck as ref_deck
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import load

WORKLOADS = ["hex8-cube-80.load-sweep", "make_example-4096x64.deck-to-vtk",
             "hex8-cube-80.creep-8"]


def test_hex_box_is_the_programs():
    a = generators.hex_box(5, 3, 4, lx=1.0, ly=2.0, lz=1.5, E=70e9, nu=0.3,
                           t=3.0, dt=1.0, tip_load=-2e5)
    p = meshgen.hex_box_problem(5, 3, 4, lx=1.0, ly=2.0, lz=1.5, E=70e9,
                                nu=0.3, t=3.0, dt=1.0, tip_load=-2e5)
    for k, v in a.items():
        if k == "blocks":
            for f, arr in v["hex"].items():
                assert np.array_equal(arr, getattr(p.blocks["hex"], f)), f
        elif isinstance(v, np.ndarray):
            assert np.array_equal(v, getattr(p, k)), k
            assert v.dtype == getattr(p, k).dtype, k
        else:
            assert v == getattr(p, k), k


@pytest.mark.parametrize("nx,ny", [(10, 1), (64, 4), (37, 5)])
def test_strip_deck_is_the_programs(nx, ny):
    text = generators.strip_deck(nx, ny) + generators.strip_forces(nx, ny)
    assert text == meshgen.quad_strip_deck(nx, ny)


def test_reference_parse_agrees_with_the_programs():
    text = generators.strip_deck(6, 3) + generators.strip_forces(
        6, 3, ((-2e10, 1e9), (-5e10, 0.0)))
    r, p = ref_deck.parse(text), load(text, backend="python")
    assert np.array_equal(r["coords"], p.coords)
    assert np.array_equal(r["conn"], p.blocks["qua"].conn)
    assert np.array_equal(r["bc_dofs"], p.bc_dofs)
    assert np.array_equal(r["force_vec"], p.force_vec)
    assert np.array_equal(r["force_dofs"], p.force_dofs)


def test_reference_against_the_programs_direct_solve():
    """A box small enough for the program's dense LU: the two agree to
    rounding (the reference's band is narrow there, so it solves directly
    too)."""
    from fem_tpu_torch.config import Config
    from fem_tpu_torch.solver import stepper

    from fembench.harness import program

    a = generators.hex_box(4, 3, 3, lx=1.0, ly=1.0, lz=1.0)
    res = stepper.run(program.problem(a), Config(device="cpu"))
    ref = reference.run(compare.reference_deck(a, a["force_vec"], False))
    assert res.path == "direct"
    assert compare.rel(res.aggregate_u, ref["u"]) < 1e-12
    assert compare.rel(res.aggregate_stress, ref["stress"]) < 1e-12


def test_reference_cg_against_its_direct_solve(monkeypatch):
    a = generators.hex_box(8, 6, 6, lx=1.0, ly=1.0, lz=1.0)
    deck = compare.reference_deck(a, a["force_vec"], False)
    monkeypatch.setattr(reference, "DIRECT_BAND", 10 ** 9)
    direct = reference.run(deck)
    monkeypatch.setattr(reference, "DIRECT_BAND", 0)
    cg = reference.run(deck)
    assert direct["iters"] == [0] and cg["iters"][0] > 0
    assert compare.rel(cg["u"], direct["u"]) < 1e-10
    assert compare.rel(cg["stress"], direct["stress"]) < 1e-10


@pytest.mark.parametrize("creep", [False, True])
def test_reference_residual_of_a_judged_increment(creep):
    """The residual that the reference reads of its own last increment is
    its solve's, and an increment off by a millionth reads about that."""
    a = generators.hex_box(6, 4, 4, lx=1.0, ly=1.0, lz=1.0, t=3.0, dt=1.0)
    a["mats"] = a["mats"].copy()
    a["mats"][:, 2], a["mats"][:, 3] = 5e11, 1.0
    deck = compare.reference_deck(a, a["force_vec"], creep)
    du = reference.run(deck)["du"]
    assert reference.run(deck, judge_du=du)["residual"] < 1e-10
    off = reference.run(deck, judge_du=du * (1.0 + 1e-6))["residual"]
    assert 1e-7 < off < 1e-5
    assert reference.run(deck, judge_du=du[:-1])["residual"] == float("inf")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_entry_against_the_reference(tiny, workload):
    """One deck of each cell through its entry and the program, at a tiny
    size: every number compared is under its limit."""
    bench, root = tiny
    cell = spec.load_cell(workload, benchmark=bench, root=root)
    entry = cell.entry_class()(cell, 2 ** 35 + 11, "cpu", False)
    inputs = entry.next_deck()
    out = entry.run_deck(inputs, 0, {})
    assert entry.deck_record(out)["path"] == "structured_mg_cg"
    try:
        values = entry.compare([entry.kept(inputs, out)])
    finally:
        entry.close()
    ok, rows = compare.judge(values, cell.limits)
    assert ok, rows


def test_float32_reference_is_what_float32_gives():
    a = generators.hex_box(6, 4, 4, lx=1.0, ly=1.0, lz=1.0)
    deck = compare.reference_deck(a, a["force_vec"], False)
    r64 = reference.run(deck)
    r32 = reference.run(deck, dtype=torch.float32)
    assert 1e-8 < compare.rel(r32["u"], r64["u"]) < 1e-3
