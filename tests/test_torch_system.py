"""fem_tpu_torch's continuum System and the stepper's path table against
fem_tpu in float64 on the shipped linear decks."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.models import problem as j_problem
from fem_tpu.models.system import System as JSystem
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def deck(name):
    return os.path.join(ROOT, "examples", "ref", name)


def close(got, ref, rtol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("name,plane_stress", [
    ("el_test.inp", False),
    ("two_quads_qs.inp", False),
    ("lin_two_quads_qs.inp", True),
])
def test_system_matches_fem_tpu(name, plane_stress):
    jp = j_problem.load(deck(name), backend="python")
    js = JSystem(jp, plane_stress=plane_stress)
    s = System(Problem.from_reference(jp), torch.float64, device="cpu",
               plane_stress=plane_stress)
    close(s.dense_K(), js.dense_K(), rtol=1e-12)
    close(s.diag(), js.diag(), rtol=1e-12)
    rng = np.random.default_rng(1)
    du = rng.normal(size=s.ndof) * 1e-3
    close(s.matvec(torch.as_tensor(du)), js.matvec(jnp.asarray(du)),
          rtol=1e-12)
    for t_init in (0.0, 0.3 * jp.t, jp.t - jp.dt):
        close(s.rhs(t_init), js.rhs(t_init), rtol=1e-12)
    close(s.bc_step_vals(), js.bc_step_vals(), rtol=1e-12)
    close(s.stress_increment(torch.as_tensor(du)),
          js.stress_increment(jnp.asarray(du)), rtol=1e-12)


def test_direct_helpers_match_fem_tpu():
    from fem_tpu.solver import direct as j_direct
    from fem_tpu_torch.solver import direct

    jp = j_problem.load(deck("lin_two_quads_qs.inp"), backend="python")
    K = np.array(JSystem(jp).dense_K())
    F = np.random.default_rng(2).normal(size=K.shape[0])
    bc, vals = np.asarray(jp.bc_dofs), np.full(jp.bc_dofs.shape, 0.01)
    t = torch.as_tensor
    for name, args in (("apply_penalty_bcs", (1e30,)), ("eliminate_bcs", ())):
        Kb, Fb = getattr(direct, name)(t(K), t(F), t(bc), t(vals), *args)
        jKb, jFb = getattr(j_direct, name)(jnp.asarray(K), jnp.asarray(F),
                                           jnp.asarray(bc), jnp.asarray(vals),
                                           *args)
        close(Kb, jKb, rtol=0)
        close(Fb, jFb, rtol=1e-14)
        fac = direct.factorize(Kb)
        close(direct.solve_factorized(fac, Fb),
              j_direct.solve_factorized(j_direct.factorize(jKb), jFb),
              rtol=1e-12)
        m, e, n = direct.det_report(fac, ref_scale=np.abs(K).max())
        jm, je, jn = j_direct.det_report(j_direct.factorize(jKb),
                                         ref_scale=np.abs(K).max())
        assert (e, n) == (je, jn) and abs(m - jm) <= 1e-12


def test_cohesive_terms_not_ported():
    s = System(problem_mod.load(deck("two_quads_qs.inp")), device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        s.coh_force(torch.zeros(s.ndof, dtype=torch.float64))


@pytest.mark.parametrize("path,name,solver,bc_mode", [
    ("el_test.inp", "direct", "direct", "penalty"),
    ("lin_two_quads_qs.inp", "direct", "direct", "eliminate"),
    ("lin_two_quads_qs.inp", "unstructured_jacobi_cg", "cg", "eliminate"),
    ("../generated_example.inp", "direct", "direct", "penalty"),
])
def test_linear_decks_match_fem_tpu(path, name, solver, bc_mode):
    jp = j_problem.load(deck(path), backend="python")
    jr = j_stepper.run(jp, JConfig(solver=solver, bc_mode=bc_mode))
    r = stepper.run(problem_mod.load(deck(path)),
                    Config(device="cpu", solver=solver, bc_mode=bc_mode))
    assert r.path == name
    assert r.nsteps == jr.nsteps
    close(r.aggregate_u, jr.aggregate_u, rtol=1e-12)
    close(r.aggregate_stress, jr.aggregate_stress, rtol=1e-12)
    if solver == "cg":
        assert r.krylov_iters == jr.krylov_iters


def test_path_table_rows():
    f = dict(explicit=False, cohesive=False, creep=False, sharded=False,
             solver="cg", structured=False, precond="jacobi")
    assert stepper.choose_path(stepper.Features(**f)) == "unstructured_jacobi_cg"
    assert stepper.choose_path(stepper.Features(
        **{**f, "structured": True})) == "structured_mg_cg"
    assert stepper.choose_path(stepper.Features(
        **{**f, "solver": "direct", "structured": True})) == "direct"
    assert stepper.choose_path(stepper.Features(
        **{**f, "explicit": True, "cohesive": True})) == "explicit"
    assert stepper.choose_path(stepper.Features(
        **{**f, "precond": "amg"})) == "unstructured_amg_or_lattice_gmg_cg"
    for key, value, item in (("cohesive", True, "A.7"), ("creep", True, "A.8"),
                             ("sharded", True, "A.9")):
        with pytest.raises(NotImplementedError, match=item):
            stepper.choose_path(stepper.Features(**{**f, key: value}))


def test_unported_rows_raise_from_run():
    with pytest.raises(NotImplementedError, match="A.7"):
        stepper.run(problem_mod.load(deck("cohesive_test_2.inp")),
                    Config(device="cpu"))
    # a jittered box (no uniform grid) above amg_threshold takes the
    # unstructured amg row: SA-AMG at or below gmg_min, converged
    box = meshgen.hex_box_problem(2, 2, 2, jitter=0.3)
    msgs = []
    r = stepper.run(box, Config(device="cpu", solver="cg", amg_threshold=10),
                    log=msgs.append)
    assert r.path == "unstructured_amg_or_lattice_gmg_cg"
    assert any("smoothed aggregation" in m for m in msgs)
    assert not any("Geometric lattice-MG" in m for m in msgs)
    assert r.krylov_iters and r.krylov_iters[0] > 0
    u_dir = stepper.run(box, Config(device="cpu", solver="direct")).aggregate_u
    close(r.aggregate_u, u_dir, rtol=1e-7)


def test_explicit_deck_writes_zeros():
    p = problem_mod.load(deck("el_test.inp"))
    p.stype = "explicit"
    r = stepper.run(p, Config(device="cpu"))
    assert r.path == "explicit"
    assert not r.aggregate_u.any() and not r.aggregate_stress.any()
