"""The cohesive cell's parts on the CPU: its frozen generator against the
program's, the plain reference's law and element against finite
differences and its opening against a one-column strip's scalar
equilibrium, its readers, and runs of the cell at a size the CPU solves in
seconds, sound and with the timed path broken underneath."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from fembench.harness import cli, compare, spec
from fembench.reference import cohesive
from fem_tpu_torch.io import meshgen

WORKLOAD = "cohesive-strip-360x72.newton"
CONFIG = "cohesive-strip-360x72"
# the program takes its matrix-free Newton with lattice GMG above 20,000 DOFs
# (21,156 here), as at the cell's own size
SMALL = dict(nx=128, ny_half=40)


def _entry_module():
    return spec._module(spec.ROOT / "entries" / "cohesive_decks.py",
                        "fembench_entry_cohesive_decks")


@pytest.mark.parametrize("nx,ny", [(3, 2), (12, 4), (7, 5)])
def test_cohesive_strip_is_the_programs(nx, ny):
    kw = dict(lx=2.0, ly_half=0.5, E=2000.0, nu=0.25, t=2.0, dt=0.5,
              open_disp=0.03, coh_props=(80.0, 0.02, 0.01, 1.0, 0.0, 0.0))
    a = _entry_module().cohesive_strip(nx, ny, **kw)
    p = meshgen.cohesive_interface_problem(nx, ny, **kw)
    for k, v in a.items():
        if k == "blocks":
            assert set(v) == set(p.blocks)
            for name, fields in v.items():
                for f, arr in fields.items():
                    got = getattr(p.blocks[name], f)
                    assert np.array_equal(arr, got) and arr.dtype == got.dtype
        elif isinstance(v, np.ndarray):
            assert np.array_equal(v, getattr(p, k)), k
            assert v.dtype == getattr(p, k).dtype, k
        else:
            assert v == getattr(p, k), k


def _props(rng):
    """A law with q and r away from the cell's (1, 0)."""
    return (rng.uniform(50, 150), rng.uniform(0.005, 0.02),
            rng.uniform(0.005, 0.02), rng.uniform(0.2, 1.5),
            rng.uniform(0.0, 0.6), 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_law_is_the_potentials_derivatives(seed):
    """T = grad phi and the tangent = grad T, by central differences of
    step 1e-7 delta in float64 (truncation ~1e-14, rounding ~1e-9 of the
    values: held to 1e-6)."""
    rng = np.random.default_rng(seed)
    props = _props(rng)
    dn_, dt_ = props[1], props[2]
    gn = torch.tensor(rng.uniform(-0.5, 2.5, 16) * dn_, dtype=torch.float64)
    gt = torch.tensor(rng.uniform(-1.5, 1.5, 16) * dt_, dtype=torch.float64)
    hn, ht = 1e-7 * dn_, 1e-7 * dt_
    t_n, t_t, k_nn, k_nt, k_tt = cohesive.law(props, gn, gt)
    phi = lambda a, b: cohesive.potential(props, a, b)  # noqa: E731
    fd_tn = (phi(gn + hn, gt) - phi(gn - hn, gt)) / (2 * hn)
    fd_tt = (phi(gn, gt + ht) - phi(gn, gt - ht)) / (2 * ht)
    np.testing.assert_allclose(t_n, fd_tn, rtol=1e-6,
                               atol=1e-6 * float(t_n.abs().max()))
    np.testing.assert_allclose(t_t, fd_tt, rtol=1e-6,
                               atol=1e-6 * float(t_t.abs().max()))
    law = lambda a, b: cohesive.law(props, a, b)  # noqa: E731
    up_n, dn_n = law(gn + hn, gt), law(gn - hn, gt)
    up_t, dn_t = law(gn, gt + ht), law(gn, gt - ht)
    scale = max(float(k_nn.abs().max()), float(k_tt.abs().max()))
    for got, fd in ((k_nn, (up_n[0] - dn_n[0]) / (2 * hn)),
                    (k_nt, (up_t[0] - dn_t[0]) / (2 * ht)),
                    (k_nt, (up_n[1] - dn_n[1]) / (2 * hn)),
                    (k_tt, (up_t[1] - dn_t[1]) / (2 * ht))):
        np.testing.assert_allclose(got, fd, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("seed", range(4))
def test_element_tangent_is_the_forces_derivative(seed):
    """Each element's 8 x 8 tangent against central differences of its
    internal force, on skewed elements at random openings."""
    rng = np.random.default_rng(100 + seed)
    props = _props(rng)
    ne = 3
    base = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    coords = (base[None] + rng.normal(scale=0.1, size=(ne, 4, 2))
              + np.arange(ne)[:, None, None] * 3.0)
    conn = np.arange(4 * ne).reshape(ne, 4)
    coh = cohesive.Interface(coords.reshape(-1, 2), conn, props,
                             dtype=torch.float64, device="cpu")
    n = 8 * ne
    u = torch.tensor(rng.normal(scale=0.7 * props[1], size=n),
                     dtype=torch.float64)
    _, ke = coh.force_and_tangent(u, n)
    h = 1e-7 * props[1]
    fd = torch.zeros(ne, 8, 8, dtype=torch.float64)
    for e in range(ne):
        for j in range(8):
            du = torch.zeros(n, dtype=torch.float64)
            du[8 * e + j] = h
            col = (coh.force(u + du, n) - coh.force(u - du, n)) / (2 * h)
            fd[e, :, j] = col[8 * e:8 * e + 8]
    np.testing.assert_allclose(ke, fd, rtol=1e-6,
                               atol=1e-6 * float(ke.abs().max()))
    np.testing.assert_allclose(ke, ke.transpose(1, 2), rtol=0,
                               atol=1e-12 * float(ke.abs().max()))


@pytest.mark.parametrize("ny,pull", [(4, 0.02), (8, 0.04), (6, 0.045)])
def test_one_column_opening_is_the_scalar_equilibrium(ny, pull):
    """A 1 x ny strip with nu = 0 is in uniaxial stress: each block carries
    sigma = E eps, so 2 h / E T(D) + D = U, h the block's height and U the
    pull, solved here by bisection on [0, delta_n] (T rises there); the
    reference's opening equals that D at every Gauss point, its tangential
    part is 0."""
    E, h = 3640.0, 1.0
    props = (100.0, 0.01, 0.01, 1.0, 0.0, 0.0)
    arrays = _entry_module().cohesive_strip(1, ny, ly_half=h, E=E, nu=0.0,
                                            open_disp=pull, coh_props=props)
    deck = _entry_module().reference_deck(arrays, arrays["bc_vals"])
    out = cohesive.run(deck)

    def f(d):
        t_n = cohesive.law(props, torch.tensor(d, dtype=torch.float64),
                           torch.tensor(0.0, dtype=torch.float64))[0]
        return 2.0 * h / E * float(t_n) + d - pull

    lo, hi = 0.0, props[1]
    assert f(lo) < 0.0 < f(hi)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if f(mid) < 0.0 else (lo, mid)
    np.testing.assert_allclose(out["openings"][..., 0], 0.5 * (lo + hi),
                               rtol=1e-10)
    np.testing.assert_allclose(out["openings"][..., 1], 0.0, atol=1e-14)


@pytest.fixture
def small(tiny):
    """(BENCHMARK.json, root) of the tiny copy with the cohesive strip cut
    to SMALL."""
    bench, root = tiny
    path = root / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg["params"].update(SMALL)
    path.write_text(json.dumps(cfg))
    return bench, root


def _run(small, trace=False):
    bench, root = small
    cell = spec.load_cell(WORKLOAD, benchmark=bench, root=root)
    result, _ = cli.execute(cell, 2 ** 36 + 1, 0.2, trace, "cpu",
                            time.perf_counter())
    return result


def test_sound_run_is_correct_and_reads_its_metrics(small):
    result = _run(small, trace=True)
    assert result["correct"], result
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("newton_iters", "residual_evals", "inner_ms",
                 "linesearch_ms", "solve_ms", "cg_iters", "host_setup_ms"):
        assert m.get(name) is not None and m[name] > 0, name
    assert 1.0 <= m["newton_iters"] <= 10.0
    assert m["residual_evals"] >= 1.0
    assert m["inner_ms"] + m["linesearch_ms"] <= m["solve_ms"]


@pytest.mark.parametrize("fault", [dict(formulation="standard"),
                                   dict(newton_rtol=1e-3),
                                   dict(dtype="float32")],
                         ids=["incremental", "newton_1e-3", "float32"])
def test_planted_fault_is_not_correct(small, fault, monkeypatch):
    """The incremental form in place of the total one, the Newton stopped at
    1e-3 of its first residual, and the program in float32: each run comes
    out not correct, by a number over its limit."""
    from fem_tpu_torch.solver import stepper

    run = stepper.run
    monkeypatch.setattr(stepper, "run", lambda problem, config=None, log=None:
                        run(problem, dataclasses.replace(config, **fault),
                            log))
    result = _run(small)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_control_fails(small):
    """The float32 reference in the program's place fails a number; the
    `solve` that the control passes (the linear reference) is not called."""
    bench, root = small
    cell = spec.load_cell(WORKLOAD, benchmark=bench, root=root)
    entry = cell.entry_class()(cell, 2 ** 36 + 5, "cpu", False)
    inputs = entry.next_deck()
    out = entry.run_deck(inputs, 0, {})

    def linear(deck):
        raise AssertionError("the linear reference cannot solve this deck")

    try:
        kept = [entry.kept(inputs, out)]
        ok, rows = compare.judge(entry.compare(kept), cell.limits)
        assert ok, rows
        ok, rows = compare.judge(entry.compare(kept, solve=linear),
                                 cell.limits)
    finally:
        entry.close()
    assert not ok, rows


def test_readers_read_nothing_without_the_newton_counters(monkeypatch):
    """A traced run of a linear deck holds span trees but no Newton
    counters or spans: the cell's new readers read None."""
    from fem_tpu_torch.config import Config
    from fem_tpu_torch.solver import stepper
    from fembench.harness import generators, program

    res = stepper.run(program.problem(generators.hex_box(4, 4, 4)),
                      Config(device="cpu", timing=True))
    record = {"decks": [dict(iters=res.krylov_iters, steps=res.nsteps,
                             path=res.path, failed=False, spans={"run": 0.1},
                             timers=dict(res.timers.totals))]}
    cell = spec.load_cell(WORKLOAD)
    for name in ("newton_iters", "residual_evals", "inner_ms",
                 "linesearch_ms"):
        assert cell.reader(name)(record) is None, name
