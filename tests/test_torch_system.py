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


def test_cohesive_terms_exist_and_balance():
    """Once unported (ROADMAP A.7), the cohesive terms now exist: a deck
    without a cohesive block has none, and on cohesive_test_2 a closed
    interface carries no force while an opened one carries forces that act
    on its cohesive nodes only and balance (action and reaction)."""
    s = System(problem_mod.load(deck("lin_two_quads_qs.inp")), device="cpu")
    assert s.coh is None
    s = System(problem_mod.load(deck("cohesive_test_2.inp")), device="cpu")
    zero = torch.zeros(s.ndof, dtype=torch.float64)
    assert not s.coh_force(zero).any()
    u = torch.as_tensor(np.random.default_rng(0).normal(size=s.ndof) * 1e-3)
    f = s.coh_force(u).reshape(-1, 2)
    assert float(f.abs().max()) > 0.0
    assert not f[[0, 1, 3, 5]].any()  # nodes 1, 2, 4, 6: no cohesive element
    assert float(f.sum(0).abs().max()) < 1e-12 * float(f.abs().max())


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
    f = dict(explicit=False, cohesive=False, sharded=False,
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
    assert stepper.choose_path(stepper.Features(
        **{**f, "cohesive": True})) == "cohesive_newton"
    # creep is not a row (ROADMAP A.8 adds it to every linear row's RHS)
    assert "creep" not in [name for name, _ in stepper.PATHS]
    # sharded runs: the element-sharded rows and the DOF-sharded tiers of a
    # structured box and of a lex-lattice AMG deck; direct solves and
    # cohesive decks keep their rows
    s = {**f, "sharded": True}
    assert stepper.choose_path(stepper.Features(**s)) == "sharded_jacobi_cg"
    assert stepper.choose_path(stepper.Features(
        **{**s, "precond": "amg"})) == "sharded_amg_cg"
    assert stepper.choose_path(stepper.Features(
        **{**s, "solver": "direct"})) == "direct"
    assert stepper.choose_path(stepper.Features(
        **{**s, "cohesive": True})) == "cohesive_newton"
    assert stepper.choose_path(stepper.Features(
        **{**s, "structured": True})) == "sharded_slab_stencil"
    assert stepper.choose_path(stepper.Features(
        **{**s, "precond": "amg", "lattice": lambda: True})) == (
            "sharded_halo_block_stencil")
    # every row has its set-up (the explicit one solves nothing)
    assert {name for name, _ in stepper.PATHS} == set(stepper._SETUP) | {
        "explicit"}


def test_no_row_raises_from_run():
    # the cohesive row (ROADMAP A.7) runs, and so does creep (A.8): el_test
    # has one step from a zero creep state, so its creep force is zero and
    # u is the elastic run's; its material (visc 1e18) barely relaxes
    r = stepper.run(problem_mod.load(deck("cohesive_test_2.inp")),
                    Config(device="cpu"))
    assert r.path == "cohesive_newton" and r.newton_iters[0] == 1
    el = problem_mod.load(deck("el_test.inp"))
    r_visc = stepper.run(el, Config(device="cpu", viscoelastic=True))
    r_el = stepper.run(el, Config(device="cpu"))
    assert r_visc.path == "direct"
    np.testing.assert_array_equal(r_visc.aggregate_u, r_el.aggregate_u)
    close(r_visc.aggregate_stress, r_el.aggregate_stress, rtol=1e-9)
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
    # no row raises any more: with n_devices the same deck takes the halo
    # block stencil, and its unjittered form the slab stencil
    r = stepper.run(box, Config(device="cpu", solver="cg", amg_threshold=10,
                                n_devices=2))
    assert r.path == "sharded_halo_block_stencil"
    close(r.aggregate_u, u_dir, rtol=1e-7)
    r = stepper.run(meshgen.hex_box_problem(2, 2, 2),
                    Config(device="cpu", solver="cg", n_devices=2))
    assert r.path == "sharded_slab_stencil"


def test_explicit_deck_writes_zeros():
    p = problem_mod.load(deck("el_test.inp"))
    p.stype = "explicit"
    r = stepper.run(p, Config(device="cpu"))
    assert r.path == "explicit"
    assert not r.aggregate_u.any() and not r.aggregate_stress.any()
