"""The matrix-free Newton-Krylov's true-equilibrium form (formulation
"total", solver "cg") against the dense total form of the port and of
fem_tpu, and against the plain reference `fembench/reference/cohesive.py`,
in float64 on the CPU; the path choice, the Newton's counters, and the
incremental form's answers as they were before the total form joined the
matrix-free loop.

The decks are cohesive strips with the material, the law and the pull drawn
from a seed: the pull is 0.6-0.9 of the least pull at which the interface
can reach its traction peak (2 h sigma_max / M + delta_n, M the constrained
modulus, the stiffest the blocks can be), so every deck stays on the
pre-peak branch, where the equilibrium is unique."""

import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.system import System
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.solver import newton, stepper
from fembench.reference import cohesive as ref_cohesive

torch.set_num_threads(1)

SIZES = [(12, 4), (24, 6)]
PRECONDS = ["jacobi", "amg"]
SEEDS = [0, 1]


def draw(seed, nx, ny):
    """(kwargs of cohesive_interface_problem) of a seeded deck: 10 load
    steps to a pull below the traction peak."""
    rng = np.random.default_rng([seed, nx, ny])
    E, nu = rng.uniform(2000.0, 6000.0), rng.uniform(0.2, 0.35)
    smax, dn, dt_ = (rng.uniform(50.0, 150.0), rng.uniform(0.005, 0.02),
                     rng.uniform(0.005, 0.02))
    modulus = E * (1.0 - nu) / ((1.0 + nu) * (1.0 - 2.0 * nu))
    peak = 2.0 * 1.0 * smax / modulus + dn  # ly_half = 1
    return dict(nx=nx, ny_half=ny, E=E, nu=nu, t=1.0, dt=0.1,
                open_disp=rng.uniform(0.6, 0.9) * peak,
                coh_props=(smax, dn, dt_, 1.0, 0.0, 0.0))


def strip(seed, nx, ny):
    return meshgen.cohesive_interface_problem(**draw(seed, nx, ny))


def cpu(**kw):
    return Config(device="cpu", **kw)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("nx,ny", SIZES)
def test_matfree_total_equals_dense_total_per_step(nx, ny, precond, seed):
    """Each load step of the matrix-free total form from the dense form's
    state ends where the dense one does, to 1e-9 of the step's largest
    displacement: both stop at ||R|| <= 1e-8 ||R_0|| of the step, and each
    one's last Newton step lands far below that (quadratic convergence), so
    they agree to rounding on these decks (a few 1e-14 measured)."""
    p = strip(seed, nx, ny)
    s = System(p, torch.float64, device="cpu")
    cfg = cpu(solver="cg", precond=precond, formulation="total")
    ops = newton.matfree_operators(s, cfg)
    # "amg": a hierarchy on the zero-opening tangent (lattice GMG here)
    assert (ops.kind == "jacobi") == (precond == "jacobi")
    agg = torch.zeros(s.ndof, dtype=torch.float64)
    du = torch.zeros_like(agg)
    for k in range(1, p.nsteps + 1):
        t_end = p.dt * k
        dense = newton.solve_step_total(s, cfg, agg, du, t_end)
        mf = newton.solve_step_matfree(s, cfg, agg, du, s.rhs(t_end - p.dt),
                                       ops=ops, t_end=t_end)
        assert dense.converged and mf.converged and mf.gmres_fallbacks == 0
        u = agg + dense.du
        assert rel((agg + mf.du).numpy(), u.numpy()) <= 1e-9, k
        agg, du = u, dense.du


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("precond", PRECONDS)
def test_matfree_total_equals_fem_tpu_dense_total(precond, seed):
    """stepper.run of the 12 x 4 deck: the port's matrix-free total form
    against fem_tpu's dense total form (its solver "direct"), u and the
    nodal stress to 1e-9 (both converge each step far below their 1e-8
    stop; the two packages' rounding differs)."""
    kw = draw(seed, 12, 4)
    r = stepper.run(meshgen.cohesive_interface_problem(**kw),
                    cpu(solver="cg", precond=precond, formulation="total"))
    assert r.path == "cohesive_newton" and all(r.newton_converged)
    assert all(i > 0 for i in r.krylov_iters)
    jr = j_stepper.run(j_meshgen.cohesive_interface_problem(**kw),
                       JConfig(solver="direct", formulation="total"))
    assert rel(r.aggregate_u, np.asarray(jr.aggregate_u)) <= 1e-9
    assert rel(r.aggregate_stress, np.asarray(jr.aggregate_stress)) <= 1e-9


def reference_deck(p):
    q, c = p.blocks["qua"], p.blocks["coh"]
    return dict(coords=p.coords, conn=q.conn, E=p.mats[0, 0],
                nu=p.mats[0, 1], coh_conn=c.conn, coh_props=p.coh_props[0],
                bc_dofs=p.bc_dofs, bc_vals=p.bc_vals, force_dofs=p.force_dofs,
                force_vec=p.force_vec, force_t1=p.force_t1,
                force_t2=p.force_t2, t=p.t, dt=p.dt)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("precond", PRECONDS)
@pytest.mark.parametrize("nx,ny", SIZES)
def test_matfree_total_equals_the_plain_reference(nx, ny, precond, seed):
    """The port's matrix-free total form against the plain reference (its
    own element and law, a full Newton on the assembled tangent with a
    direct solve, to 1e-12): u, the nodal stress and the openings to 1e-9
    (the program's answer is converged far below its 1e-8 stop; the two
    assemble in another order), and the true residual of the program's u in
    the reference's K and law under 1e-9."""
    p = strip(seed, nx, ny)
    r = stepper.run(p, cpu(solver="cg", precond=precond, formulation="total"))
    deck = reference_deck(p)
    ref = ref_cohesive.run(deck)
    assert rel(r.aggregate_u, ref["u"]) <= 1e-9
    assert rel(r.aggregate_stress, ref["stress"]) <= 1e-9
    assert rel(ref_cohesive.openings(deck, r.aggregate_u),
               ref["openings"]) <= 1e-9
    assert ref_cohesive.residual(deck, r.aggregate_u) <= 1e-9
    # below the traction peak, opened
    assert 0.0 < ref["openings"][..., 0].max() < p.coh_props[0, 1]


@pytest.mark.parametrize("precond", PRECONDS)
def test_total_cg_never_forms_the_dense_matrix(precond, monkeypatch):
    def refuse(self):
        raise AssertionError("dense K formed")

    monkeypatch.setattr(System, "dense_K", refuse)
    monkeypatch.setattr(System, "coh_stiffness_dense", refuse)
    r = stepper.run(strip(0, 12, 4), cpu(solver="cg", precond=precond,
                                         formulation="total"))
    assert r.path == "cohesive_newton" and all(r.newton_converged)


def test_total_direct_takes_the_dense_form(monkeypatch):
    calls = []
    total = newton.solve_step_total

    def counted(*a, **kw):
        calls.append(1)
        return total(*a, **kw)

    monkeypatch.setattr(newton, "solve_step_total", counted)
    monkeypatch.setattr(newton, "solve_step_matfree", None)
    p = strip(0, 12, 4)
    r = stepper.run(p, cpu(solver="direct", formulation="total"))
    assert len(calls) == p.nsteps and r.krylov_iters == [0] * p.nsteps


def test_total_form_needs_the_step_end():
    p = strip(0, 12, 4)
    s = System(p, torch.float64, device="cpu")
    z = torch.zeros(s.ndof, dtype=torch.float64)
    with pytest.raises(ValueError):
        newton.solve_step_matfree(s, cpu(formulation="total"), z, z, z)


@pytest.mark.parametrize("formulation", ["total", "standard"])
@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_counters_equal_the_step_lists(solver, formulation):
    """The run's counters newton_iters, newton_residuals, inner_iters and
    gmres_fallbacks are the sums of StepResult's lists; the new span
    newton.inner.tangent lies inside newton.inner on the matrix-free form."""
    p = strip(1, 12, 4)
    r = stepper.run(p, cpu(solver=solver, formulation=formulation,
                           bc_mode="eliminate"))
    c = r.timers.counters
    assert c["newton_iters"] == sum(r.newton_iters) > 0
    assert c["newton_residuals"] == sum(r.newton_residuals)
    assert sum(r.newton_residuals) >= sum(r.newton_iters) + p.nsteps
    assert c["inner_iters"] == sum(r.krylov_iters)
    assert c["gmres_fallbacks"] == sum(r.gmres_fallbacks) == 0
    spans = r.timers.span_totals()
    if solver == "cg":
        assert 0.0 < spans["newton.inner.tangent"] <= spans["newton.inner"]
        assert spans["newton.linesearch"] > 0.0
    else:
        assert "newton.inner.tangent" not in spans


def test_sharded_total_form_runs_element_sharded():
    """formulation "total" under n_devices > 1 takes the element-sharded
    operator (one all-reduce per K_el product) and gives the single-device
    answer."""
    p = strip(0, 12, 4)
    one = stepper.run(p, cpu(solver="cg", formulation="total"))
    runs = []
    cols = commcount.collectives(lambda: runs.append(stepper.run(
        p, cpu(solver="cg", formulation="total", n_devices=4))))
    assert (sum(c[0] == "all_reduce_sum" for c in cols)
            > sum(runs[0].krylov_iters))
    assert rel(runs[0].aggregate_u, one.aggregate_u) <= 1e-10


# the incremental form's answers on the parent of the total form's move into
# the matrix-free loop (the same code then and now: they must not move)
INCREMENTAL = {
    ((12, 4), "jacobi"): dict(
        newton=[3, 3, 3, 2], inner=[125, 90, 116, 72],
        norm=0.13503053914890478,
        at={51: 0.002719187288300974, 103: 0.00733853441514278,
            155: 0.010193675078669737, 207: 0.015050323172368535},
        s_norm=478.4325467676922),
    ((12, 4), "amg"): dict(
        newton=[3, 3, 3, 2], inner=[15, 13, 16, 10],
        norm=0.13503053914890245,
        at={51: 0.0027191872883055145, 103: 0.007338534415141949,
            155: 0.010193675078671745, 207: 0.01505032317236806},
        s_norm=478.4325467676536),
    ((24, 6), "jacobi"): dict(
        newton=[3, 3, 3, 2], inner=[261, 188, 260, 143],
        norm=0.22051288291565319,
        at={139: 0.003075736625819351, 279: 0.008086937666577858,
            419: 0.01190820611309594, 559: 0.016873510676888453},
        s_norm=775.0276660919118),
    ((24, 6), "amg"): dict(
        newton=[3, 3, 3, 2], inner=[15, 13, 16, 10],
        norm=0.22051288291567184,
        at={139: 0.0030757366258213747, 279: 0.008086937666581907,
            419: 0.011908206113096648, 559: 0.01687351067689414},
        s_norm=775.0276660918479),
}


@pytest.mark.parametrize("size,precond", sorted(INCREMENTAL))
def test_incremental_form_gives_the_same_answers(size, precond):
    """The default (incremental) matrix-free form: the same Newton and inner
    iterations per step, and u and the stress to 1e-12 (rounding of another
    thread count or build)."""
    p = meshgen.cohesive_interface_problem(*size, t=1.0, dt=0.25,
                                           open_disp=0.02)
    r = stepper.run(p, cpu(solver="cg", precond=precond))
    want = INCREMENTAL[(size, precond)]
    assert r.newton_iters == want["newton"]
    assert r.krylov_iters == want["inner"]
    assert np.linalg.norm(r.aggregate_u) == pytest.approx(want["norm"],
                                                          rel=1e-12)
    for i, v in want["at"].items():
        assert r.aggregate_u[i] == pytest.approx(v, rel=1e-10)
    assert np.linalg.norm(r.aggregate_stress) == pytest.approx(
        want["s_norm"], rel=1e-12)
