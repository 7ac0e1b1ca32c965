"""The port's cohesive Newton path against fem_tpu's dense SNES forms and the
reference's own checks (golden structure, the Abaqus UEL cross-validation,
snap-back), in float64 on the CPU. fem_tpu's matrix-free Newton tests are
slow, so the matrix-free forms here are held against the dense ones."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.config import Config as JConfig
from fem_tpu.models import problem as j_problem
from fem_tpu.models.system import System as JSystem
from fem_tpu.solver import newton as j_newton
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen, vtk
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import cohesive as coh
from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.solver import amg, direct, gmg, newton, stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHESIVE_DECK = os.path.join(ROOT, "examples", "ref", "cohesive_test_2.inp")
CZM_DECK = os.path.join(ROOT, "examples", "czm_instability.inp")
ABAQUS_PAIR_SUM = 0.0489376440 + 0.0131128022  # CZM_for_instability_test.log


def cpu(**kw):
    return Config(device="cpu", **kw)


def test_cohesive_snes_structure_matches_fem_tpu():
    """tests/test_golden.py::test_cohesive_snes_structure on the port, with
    fem_tpu's Newton counts and displacements."""
    p = problem_mod.load(COHESIVE_DECK)
    r = stepper.run(p, cpu())
    assert r.path == "cohesive_newton" and r.nsteps == 2
    assert r.newton_iters[0] == 1
    u = r.aggregate_u.reshape(p.nnds, p.pdim)
    np.testing.assert_allclose(u[[6, 7], 1], 0.1, atol=1e-10)
    assert np.isfinite(r.aggregate_u).all()
    assert np.isfinite(r.aggregate_stress).all()
    assert r.gmres_fallbacks == [0, 0] and r.krylov_iters == [0, 0]
    jr = j_stepper.run(j_problem.load(COHESIVE_DECK), JConfig())
    assert r.newton_iters == jr.newton_iters
    np.testing.assert_allclose(r.aggregate_u, jr.aggregate_u, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(r.aggregate_stress, jr.aggregate_stress,
                               rtol=0, atol=1e-9)


def test_cohesive_quirks_mode_runs():
    r = stepper.run(problem_mod.load(COHESIVE_DECK), cpu(quirks=True))
    assert r.path == "cohesive_newton"
    assert np.isfinite(r.aggregate_u).all()


@pytest.mark.parametrize("quirks", [False, True])
@pytest.mark.parametrize("bc_mode", ["penalty", "eliminate"])
def test_solve_step_matches_fem_tpu(bc_mode, quirks):
    """Two load steps of the dense SNES form, each from the same state in
    both packages: the same Newton iterations and du to 1e-10. (With quirks
    and penalty BCs the second step's Jacobian is numerically singular, and
    the two LAPACK builds return different members of its null space: only
    the first step is compared there.)"""
    jp = j_problem.load(COHESIVE_DECK, backend="python")
    js = JSystem(jp)
    s = System(Problem.from_reference(jp), torch.float64, device="cpu")
    agg = np.zeros(s.ndof)
    du0 = np.zeros(s.ndof)
    steps = 1 if (quirks and bc_mode == "penalty") else 2
    for k in range(steps):
        t = jp.dt * k
        jr = j_newton.solve_step(js, JConfig(quirks=quirks), jnp.asarray(agg),
                                 jnp.asarray(du0), js.rhs(t), bc_mode=bc_mode)
        r = newton.solve_step(s, cpu(quirks=quirks), torch.as_tensor(agg),
                              torch.as_tensor(du0), s.rhs(t), bc_mode=bc_mode)
        assert r.iters == jr.iters and r.converged == jr.converged
        ref = np.asarray(jr.du)
        np.testing.assert_allclose(r.du.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
        agg, du0 = agg + ref, ref.copy()


def test_czm_total_formulation_matches_abaqus_and_fem_tpu():
    """tests/test_czm_abaqus.py on the port: the true-equilibrium Newton
    reaches the symmetric solution, whose interface force agrees with the
    Abaqus UEL log to 0.1%, with fem_tpu's Newton counts."""
    p = problem_mod.load(CZM_DECK)
    cfg = dict(solver="direct", formulation="total", newton_maxit=100)
    r = stepper.run(p, cpu(**cfg))
    assert all(it <= 10 for it in r.newton_iters), r.newton_iters
    u = r.aggregate_u.reshape(8, 2)
    np.testing.assert_allclose(u[0, 1], 0.1, atol=1e-12)
    gap0, gap1 = u[1, 1] - u[6, 1], u[4, 1] - u[7, 1]
    np.testing.assert_allclose([gap0, gap1], 0.0999494, rtol=1e-4)
    s = System(p, torch.float64, device="cpu")
    fy = s.coh_force(torch.as_tensor(r.aggregate_u)).numpy().reshape(8, 2)[
        :, 1]
    bottom_sum = fy[6] + fy[7]
    t_n, _ = coh.xu_needleman_traction(
        torch.as_tensor(p.coh_props[0]), torch.tensor(gap0),
        torch.tensor(0.0, dtype=torch.float64),
        torch.tensor(0.0, dtype=torch.float64))
    np.testing.assert_allclose(bottom_sum, float(t_n), rtol=1e-6)
    np.testing.assert_allclose(bottom_sum / 2.0, ABAQUS_PAIR_SUM, rtol=2e-3)
    np.testing.assert_allclose(fy[6], -fy[1], rtol=1e-12)
    np.testing.assert_allclose(fy[7], -fy[4], rtol=1e-12)
    jr = j_stepper.run(j_problem.load(CZM_DECK), JConfig(**cfg))
    assert r.newton_iters == jr.newton_iters
    np.testing.assert_allclose(r.aggregate_u, jr.aggregate_u, rtol=0,
                               atol=1e-12)


def test_czm_incremental_drift_documented():
    """The reference-style incremental scheme overshoots the interface force
    by ~100x on this deck: why formulation="total" exists."""
    p = problem_mod.load(CZM_DECK)
    r = stepper.run(p, cpu(solver="direct", bc_mode="eliminate",
                           formulation="standard", newton_maxit=60))
    s = System(p, torch.float64, device="cpu")
    f = s.coh_force(torch.as_tensor(r.aggregate_u)).numpy()
    assert f.reshape(8, 2)[[6, 7], 1].sum() > 10.0  # 0.124 at equilibrium


def unpermute(u, nnds, pdim, seed=0):
    """u of meshgen.permute_nodes(p, seed) in p's node numbering."""
    perm = np.random.default_rng(seed).permutation(nnds)
    out = np.empty((nnds, pdim))
    out[perm] = u.reshape(nnds, pdim)
    return out.reshape(-1)


@pytest.mark.parametrize("nx,ny", [(4, 2), (6, 3)])
@pytest.mark.parametrize("inner", ["jacobi", "gmg", "sa_permuted"])
def test_matfree_matches_dense(nx, ny, inner):
    """Two steps of the matrix-free Newton-Krylov against the dense SNES form
    to 1e-6 max|u|: Jacobi-PCG; lattice GMG on the zero-opening tangent
    (amg_threshold=1 forces the hierarchy at this size); SA-AMG on the
    node-permuted strip, whose K_el is no lattice."""
    p = meshgen.cohesive_interface_problem(nx, ny, open_disp=0.004, t=1.0,
                                           dt=0.5)
    dense = stepper.run(p, cpu(solver="direct", bc_mode="eliminate"))
    prob = meshgen.permute_nodes(p, seed=0) if inner == "sa_permuted" else p
    msgs = []
    r = stepper.run(prob, cpu(solver="cg", amg_threshold=(
        20000 if inner == "jacobi" else 1)), log=msgs.append)
    assert r.path == "cohesive_newton" and all(
        it > 0 for it in r.krylov_iters)
    kind = {"jacobi": None, "gmg": "lattice GMG",
            "sa_permuted": "SA-AMG"}[inner]
    assert kind is None or any(kind in m for m in msgs)
    u = r.aggregate_u
    if inner == "sa_permuted":
        u = unpermute(u, p.nnds, p.pdim)
    scale = np.abs(dense.aggregate_u).max()
    np.testing.assert_allclose(u, dense.aggregate_u, rtol=0, atol=1e-6 * scale)
    assert r.gmres_fallbacks == [0, 0]
    # CPU tensors never launch a kernel
    assert sum(cuda_kernels.launches.values()) == 0


def test_lattice_gmg_takes_the_full_tangent():
    """Lattice detection on K_el; the hierarchy is built from
    K_el + K_coh(0), whose seam couplings must stay inside the lattice."""
    p = meshgen.cohesive_interface_problem(6, 3, open_disp=0.004, dt=0.5)
    s = System(p, torch.float64, device="cpu")
    ops = newton.matfree_operators(s, cpu(solver="cg", amg_threshold=1))
    assert ops.kind == "gmg" and ops.mg.hier.levels[0].dims == (8, 7)
    # the block stencil is K_el, bit for bit against the dense K
    v = torch.as_tensor(np.random.default_rng(0).normal(size=s.ndof))
    np.testing.assert_allclose(ops.el_mv(v).numpy(), (s.dense_K() @ v).numpy(),
                               rtol=0, atol=1e-12 * float(s.dense_K().abs()
                                                          .max()))


def _snapback_state(zeta, delta=0.001, device="cpu"):
    """tests/test_snapback.py's state: the 8x4 strip's interface rigidly
    opened to 2 delta_n, past the traction peak, where the tangent is
    strongly indefinite."""
    p = meshgen.cohesive_interface_problem(
        8, 4, open_disp=0.004, t=1.0, dt=0.25, E=3640.0, nu=0.3,
        coh_props=(100.0, delta, delta, 1.0, 0.0, zeta))
    s = System(p, torch.float64, device=device)
    n_block = 9 * 5
    agg = np.zeros(s.ndof)
    agg[np.arange(n_block, 2 * n_block) * 2 + 1] = 2.0 * delta
    return s, torch.as_tensor(agg, device=device)


def test_gmres_fallback_rescues_cg_newton():
    s, agg = _snapback_state(zeta=0.02)
    du0 = torch.zeros(s.ndof, dtype=torch.float64)
    F = s.rhs(0.0)
    J = (s.dense_K() + s.coh_stiffness_dense(agg)).numpy()
    free = np.ones(s.ndof, bool)
    free[s.bc_dofs.numpy()] = False
    assert np.linalg.eigvalsh(J[free][:, free]).min() < -1e3
    r_cg = newton.solve_step_matfree(s, cpu(solver="cg", inner_krylov="cg"),
                                     agg, du0, F)
    assert not r_cg.converged and r_cg.gmres_fallbacks == 0
    r_auto = newton.solve_step_matfree(s, cpu(solver="cg"), agg, du0, F)
    assert r_auto.converged and r_auto.gmres_fallbacks >= 1
    r_dense = newton.solve_step(s, cpu(solver="direct"), agg, du0, F,
                                bc_mode="eliminate")
    assert r_dense.converged
    nd = float(torch.linalg.norm(r_dense.du))
    assert float(torch.linalg.norm(r_auto.du - r_dense.du)) < 1e-5 * nd
    # more viscous regularization: plain CG converges, no fallback
    s, agg = _snapback_state(zeta=0.05)
    r = newton.solve_step_matfree(s, cpu(solver="cg"), agg, du0, F)
    assert r.converged and r.gmres_fallbacks == 0
    r_fx = newton.solve_step_matfree(s, cpu(solver="cg", forcing="fixed"),
                                     agg, du0, F)
    assert r_fx.converged
    assert float(torch.linalg.norm(r.du - r_fx.du)) < 1e-5 * float(
        torch.linalg.norm(r_fx.du))


@pytest.mark.cuda
def test_gmres_fallback_on_card():
    """The snap-back step on the card: the GMRES fallback (its Givens
    rotations on the host, the basis on the card) converges and agrees with
    the dense Newton there and with the same run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    du = {}
    for device in ("cuda", "cpu"):
        s, agg = _snapback_state(zeta=0.02, device=device)
        du0 = torch.zeros_like(agg)
        F = s.rhs(0.0)
        r = newton.solve_step_matfree(
            s, Config(device=device, solver="cg"), agg, du0, F)
        assert r.converged and r.gmres_fallbacks >= 1
        du[device] = r.du.cpu()
        if device == "cuda":
            r_dense = newton.solve_step(
                s, Config(device=device, solver="direct"), agg, du0, F,
                bc_mode="eliminate")
            assert r_dense.converged
            du["dense"] = r_dense.du.cpu()
    nd = float(torch.linalg.norm(du["dense"]))
    assert float(torch.linalg.norm(du["cuda"] - du["dense"])) < 1e-5 * nd
    assert float(torch.linalg.norm(du["cuda"] - du["cpu"])) < 1e-5 * nd


def test_hierarchy_built_once_per_run(monkeypatch):
    calls = {"gmg": 0, "amg": 0}

    def counting(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    counting(gmg, "build_lattice", "gmg")
    counting(amg, "build", "amg")
    p = meshgen.cohesive_interface_problem(4, 2, open_disp=0.004, t=1.0,
                                           dt=0.25)
    r = stepper.run(p, cpu(solver="cg", amg_threshold=1))
    assert r.nsteps == 4 and len(r.newton_iters) == 4
    assert calls == {"gmg": 1, "amg": 0}


def test_robust_solve_pins_null_rows_and_takes_min_norm():
    """A fully separated interface leaves dofs with no stiffness: their rows
    are pinned (relative to max|K_el|, not to the 1e30 penalty rows), and an
    exactly singular remainder takes the SVD minimum-norm solution."""
    rng = np.random.default_rng(3)
    B = rng.normal(size=(6, 6))
    K = B @ B.T + 6 * np.eye(6)
    J = np.zeros((9, 9))
    J[:6, :6] = K
    J[6, 6] = 1e30  # a penalty row
    J[7, 7] = 1e-20  # a null row of the physical scale
    b = rng.normal(size=9)
    x = direct.robust_solve(torch.as_tensor(J), torch.as_tensor(b),
                            ref=float(np.abs(K).max()))
    np.testing.assert_allclose(x[:6].numpy(), np.linalg.solve(K, b[:6]),
                               rtol=1e-12)
    assert float(x[7]) == 0.0 and float(x[8]) == 0.0
    np.testing.assert_allclose(float(x[6]), b[6] / 1e30, rtol=1e-12)
    # with max|J| as the scale every physical row would count as null
    x_bad = direct.robust_solve(torch.as_tensor(J), torch.as_tensor(b))
    assert float(x_bad[:6].abs().max()) == 0.0
    # rank-deficient, no null row: two identical rows -> min-norm solution
    S = np.array([[2.0, 1.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 3.0]])
    rhs = np.array([1.0, 1.0, 3.0])
    xs = direct.robust_solve(torch.as_tensor(S), torch.as_tensor(rhs))
    np.testing.assert_allclose(xs.numpy(),
                               np.linalg.lstsq(S, rhs, rcond=None)[0],
                               rtol=1e-12)


def test_cli_vtk_matches_fem_tpu(tmp_path, monkeypatch):
    """The CLI on cohesive_test_2 against fem_tpu's CLI. As on the elastic
    deck's direct path (ROADMAP C), the two LAPACK builds may flip the sign
    of rounded-to-zero stress, so the files may differ only in "-.000000"
    against ".000000"."""
    for name, main in (("jax", j_cli_main), ("torch", cli_main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        args = ["-f", COHESIVE_DECK, "-q", "--formulation", "auto"]
        assert main(args + (["--device", "cpu"] if name == "torch" else [])
                    ) == 0
    ours = (tmp_path / "torch" / "0_output_000000.vtk").read_bytes()
    ref = (tmp_path / "jax" / "0_output_000000.vtk").read_bytes()
    assert ours.replace(b"-.000000", b".000000") == ref.replace(
        b"-.000000", b".000000")
    _, _, disp = vtk.read_fields(str(tmp_path / "torch" /
                                     "0_output_000000.vtk"))
    np.testing.assert_allclose(disp[[6, 7], 1], 0.1, atol=1e-12)  # nodes 7, 8
