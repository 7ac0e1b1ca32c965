"""Newton with line search for the cohesive nonlinear step (the SNES role).

Port of `fem_tpu.solver.newton`. Replicates the reference's SNESNEWTONLS set-up
(main.F90:199-214; callbacks CalcJacobian m_global.F90:98-158 and CalcResidual
m_global.F90:161-235):

  residual  R(du) = J(du) du - F_ext - F_coh(aggregate_u + du)
            with the BC rows overridden (penalty: R_bc = p du_bc - p u_bc)
  jacobian  J(du) = K_el + K_coh(aggregate_u + du) + BC rows

The reference residual multiplies by the *Jacobian*, not the plain elastic K
(MatMultAdd(Jacobian, du, ...), m_global.F90:226); `formulation="reference"`
reproduces that and `"standard"` uses the textbook incremental residual
R = K_el du - F_ext - F_coh(aggregate_u + du), whose consistent Jacobian is the
same J. `solve_step_total` solves the true equilibrium instead.

Three forms, one Newton each:
  - solve_step: dense J and the robust dense solve (direct.robust_solve), for
    deck-scale problems, penalty or eliminated BCs;
  - solve_step_total: dense, true equilibrium at the step's end time;
  - solve_step_matfree: matrix-free Newton-Krylov, J v = K_el v + K_coh(u) v,
    with PCG (Jacobi, or lattice GMG / SA-AMG built once per run on the
    zero-opening tangent, see MatfreeOperators), Eisenstat-Walker forcing and
    a GMRES fallback when the tangent turns indefinite. Its residual is the
    incremental one or, under formulation="total", solve_step_total's true
    equilibrium, so the total form needs no dense matrix above the direct
    threshold.

Newton controls follow SNES defaults (Config.newton_*): rtol 1e-8 relative to
the first residual of each solve, atol 1e-50, stol 1e-8, 50 iterations, with
a backtracking line search. Everything runs in the config dtype (float64 by
default; the H100 has native FP64, so there is no float32 inner solve).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from fem_tpu_torch.config import Config
from fem_tpu_torch.models.system import PENALTY, System
from fem_tpu_torch.ops import operator
from fem_tpu_torch.solver import amg, cg, direct, hierarchy
from fem_tpu_torch.solver import gmres as gmres_mod
from fem_tpu_torch.utils import timing


class NewtonResult(NamedTuple):
    du: torch.Tensor
    iters: int
    resnorm: float
    converged: bool
    # inner solves that took the GMRES fallback (matrix-free form only)
    gmres_fallbacks: int = 0
    # inner Krylov iterations over all Newton iterations (matrix-free form)
    inner_iters: int = 0
    # residual evaluations, the line search's trials included
    residuals: int = 0


def _norm(x) -> float:
    return float(torch.linalg.norm(x))


def _bc_state(system: System, bc_vals):
    """(bool mask of constrained dofs, vector holding bc_vals there)."""
    mask = torch.zeros(system.ndof, dtype=torch.bool, device=system.device)
    mask[system.bc_dofs] = True
    ubc = torch.zeros(system.ndof, dtype=system.dtype, device=system.device)
    ubc[system.bc_dofs] = bc_vals
    return mask, ubc


def _eliminate(J, mask, bc_dofs):
    """Zero the constrained rows and columns, unit diagonal."""
    J = torch.where(mask[:, None] | mask[None, :], torch.zeros_like(J), J)
    J[bc_dofs, bc_dofs] = 1.0
    return J


def _line_search(residual: Callable, pin: Callable, x, delta, rnorm: float,
                 halvings: int):
    """Backtracking search (SNESNEWTONLS-style): lam = 1, 1/2, ... until
    ||R(x + lam delta)|| <= (1 - 1e-4 lam) rnorm, keeping the best finite
    decrease met. Returns (lam, trial x, its residual, its norm), or None
    when no trial decreased the residual."""
    lam = 1.0
    best, best_r = None, rnorm
    for _ in range(halvings):
        trial = pin(x + lam * delta)
        R = residual(trial)
        r = _norm(R)
        if math.isfinite(r) and r < best_r:
            best, best_r = (lam, trial, R, r), r
            if r <= (1.0 - 1e-4 * lam) * rnorm:
                break
        lam *= 0.5
    return best


def _counted(residual: Callable):
    """(residual, calls): `residual` that counts its calls in calls[0]."""
    calls = [0]

    def counted(x):
        calls[0] += 1
        return residual(x)

    return counted, calls


def _dense_newton(residual, jacobian, pin, x, config: Config, kref,
                  halvings: int):
    """The dense Newton loop shared by solve_step and solve_step_total.
    Returns (x, iterations, residual norm, converged, residual calls)."""
    residual, calls = _counted(residual)
    R = residual(x)
    rnorm = _norm(R)
    tol = max(config.newton_rtol * rnorm, config.newton_atol)
    iters = 0
    converged = rnorm <= tol
    while not converged and iters < config.newton_maxit:
        delta = direct.robust_solve(jacobian(x), -R, ref=kref)
        best = _line_search(residual, pin, x, delta, rnorm, halvings)
        if best is None:
            break  # stagnation: SNES reports a line-search failure
        _, x_new, R, rnorm = best
        step_norm = _norm(x_new - x)
        x = x_new
        iters += 1
        if rnorm <= tol or step_norm <= config.newton_stol * max(
                _norm(x), 1e-300):
            converged = True
    return x, iters, rnorm, converged, calls[0]


def solve_step(system: System, config: Config, aggregate_u, du0, F_ext,
               bc_mode: str = "penalty") -> NewtonResult:
    """One nonlinear load increment with the dense Jacobian. du0 is the warm
    start (the reference never zeroes Vec_U between steps, main.F90:230)."""
    quirks = config.quirks
    reference_form = config.resolve_formulation(bc_mode) == "reference"
    penalty = bc_mode == "penalty"
    bc = system.bc_dofs
    bc_vals = system.bc_step_vals()
    mask, ubc = _bc_state(system, bc_vals)
    K_el = system.dense_K()

    def jacobian_raw(du):
        return K_el + system.coh_stiffness_dense(aggregate_u + du, quirks)

    def jacobian(du):
        J = jacobian_raw(du)
        if penalty:
            J[bc, bc] = PENALTY
            return J
        return _eliminate(J, mask, bc)

    def residual(du):
        # F = F_ext + F_coh, BC rows inserted, R = J du - F
        # (m_global.F90:186-226). The product uses the RAW operator so free
        # equations see the K[free, bc] u_bc coupling; only the BC rows are
        # overridden.
        F = F_ext + system.coh_force(aggregate_u + du, quirks)
        mul = jacobian_raw(du) if reference_form else K_el.clone()
        if penalty:
            F[bc] = PENALTY * bc_vals
            mul[bc, bc] = PENALTY
            return mul @ du - F
        return torch.where(mask, du - ubc, mul @ du - F)

    def pin(du):
        return du if penalty else torch.where(mask, ubc, du)

    du, iters, rnorm, converged, nres = _dense_newton(
        residual, jacobian, pin, pin(du0), config, K_el.abs().max(),
        halvings=20)
    return NewtonResult(du=du, iters=iters, resnorm=rnorm, converged=converged,
                        residuals=nres)


def solve_step_total(system: System, config: Config, aggregate_u, du0,
                     t_end) -> NewtonResult:
    """True-equilibrium Newton for the cohesive step (formulation="total").

    The reference's incremental scheme re-applies the TOTAL cohesive force as
    a load every increment (CalcResidual adds F_coh(aggregate + du) to Vec_F
    each step, m_global.F90:186-206, while the elastic term sees only the
    increment), so over k steps it solves K u = F_ext + sum_j F_coh(u_j), a
    drifting approximation. This solves the equilibrium at time t_end,

        R(u) = K_el u - F_ext_cumulative(t_end) - F_coh(u),  u = agg + du,

    with the consistent Jacobian K_el + K_coh(u) and eliminated BCs pinned to
    the total ramp value: what matches the Abaqus UEL cross-validation."""
    quirks = config.quirks
    bc = system.bc_dofs
    mask, u_bc = _bc_state(system, system.bc_total_vals(t_end))
    F_ext = system.rhs_cumulative(t_end)
    K_el = system.dense_K()

    def residual(u):
        R = K_el @ u - (F_ext + system.coh_force(u, quirks))
        return torch.where(mask, u - u_bc, R)

    def jacobian(u):
        return _eliminate(K_el + system.coh_stiffness_dense(u, quirks), mask,
                          bc)

    def pin(u):
        return torch.where(mask, u_bc, u)

    u, iters, rnorm, converged, nres = _dense_newton(
        residual, jacobian, pin, pin(aggregate_u + du0), config,
        K_el.abs().max(), halvings=25)
    return NewtonResult(du=u - aggregate_u, iters=iters, resnorm=rnorm,
                        converged=converged, residuals=nres)


# ---------------- matrix-free Newton-Krylov ----------------


@dataclasses.dataclass(frozen=True)
class MatfreeOperators:
    """What the matrix-free Newton keeps for a whole run: the elastic
    product K_el v, its diagonal, and the inner preconditioner.

    With no hierarchy (mg None) the fused operator and Jacobi-PCG.
    Otherwise hierarchy.build on the assembled K_el: its block stencil or
    the fused operator, and a hierarchy built ONCE from the tangent at zero
    opening, K_el + K_coh(0), lattice GMG on a lattice and else SA-AMG with
    the default, deep coarse_max. K_el never changes and the zero-opening
    Xu-Needleman tangent is a large penalty-like interface stiffness, so an
    elastic-only hierarchy would be weakest exactly on the first, hardest
    Newton solve; the reference instead refactorizes the true tangent with
    MUMPS every SNES iteration (main.F90:365-371)."""

    el_mv: Callable
    el_diag: torch.Tensor
    mg: Optional[hierarchy.FineAndHierarchy] = None

    @property
    def kind(self) -> str:  # "jacobi" | "gmg" | "amg"
        return "jacobi" if self.mg is None else self.mg.kind


def matfree_operators(system: System, config: Config,
                      log: Optional[Callable[[str], None]] = None,
                      sharded_op=None) -> MatfreeOperators:
    """Build the run's MatfreeOperators (see the class); the preconditioner
    kind follows config.resolve_precond: Jacobi below `amg_threshold` DOFs,
    a hierarchy at or above it. With `sharded_op` (a
    parallel.ops.ShardedOperator) every elastic product K_el v, in the
    residual, the Jacobian and the hierarchy's fine level, runs
    element-sharded over its device mesh; the cohesive interface block is
    O(surface) and stays on shard 0, with the hierarchy's coarse levels
    (fem_tpu `newton.py:610-635,956-962`)."""
    n = system.ndof
    if config.resolve_precond(n) != "amg":
        if sharded_op is not None:
            return MatfreeOperators(el_mv=sharded_op.matvec,
                                    el_diag=sharded_op.diag())
        fop = operator.build(system)
        return MatfreeOperators(el_mv=lambda v: operator.matvec(fop, v),
                                el_diag=operator.diag(fop))
    with timing.span("assemble") as s_asm:
        A_el = amg.assemble_csr(system)
        # tangent at zero opening; its viscous term depends on dt
        ke0 = system.coh_ke(torch.zeros(n, dtype=system.dtype,
                                        device=system.device)).cpu().numpy()
        ed = system.coh["edofs"].cpu().numpy()
        nde = ed.shape[1]
        A = A_el + sp.coo_matrix(
            (ke0.reshape(-1), (np.repeat(ed, nde, axis=1).reshape(-1),
                               np.tile(ed, (1, nde)).reshape(-1))),
            shape=A_el.shape).tocsr()
    mg = hierarchy.build(system, A_el, A_hier=A, fine=(
        None if sharded_op is None else sharded_op.matvec))
    if log is not None:
        fine = ("element-sharded fused" if sharded_op is not None
                else "block stencil" if mg.dims else "fused")
        wall = s_asm.seconds + sum(s.seconds for s in mg.spans.values())
        log(f"Newton-Krylov set-up: {fine} operator, "
            f"{'lattice GMG' if mg.kind == 'gmg' else 'SA-AMG'} on the "
            f"zero-opening tangent, level sizes {mg.sizes}, {wall:.2f} s")
    return MatfreeOperators(
        el_mv=mg.fine, mg=mg,
        el_diag=timing.upload(A_el.diagonal(), dtype=system.dtype,
                              device=system.device))


def solve_step_matfree(system: System, config: Config, aggregate_u, du0,
                       F_ext, ops: Optional[MatfreeOperators] = None,
                       log: Optional[Callable[[str], None]] = None,
                       t_end: Optional[float] = None) -> NewtonResult:
    """Matrix-free Newton-Krylov for large cohesive problems.

    solve_step's residual and Jacobian (eliminated BCs) or, under
    formulation="total", solve_step_total's: R = K_el u - F_ext_cumulative(
    t_end) - F_coh(u) with u = aggregate_u + du, the held dofs of u pinned to
    their total ramp value at t_end (F_ext is then not read). Either way the
    unknown is the increment du, warm-started at du0, and J delta = -R is
    solved matrix-free, J v = K_el v + K_coh(u) v, by PCG: Jacobi with |diag J|
    and max(200, 4 sqrt(n)) iterations, or 200 iterations around the run's
    hierarchy (`ops`, built here when not given). The cohesive element
    tangents are formed once per Newton iteration.

    Past the Xu-Needleman traction peak the cohesive tangent turns
    INDEFINITE (the reference leans on MUMPS pivoting there,
    main.F90:365-371, and its commented-out alternative is gmres+asm,
    main.F90:392-394). CG's recurrence residual then proves nothing, so each
    direction's TRUE residual is checked, with CG's negative-curvature flag;
    when either fails, GMRES(30) with the Jacobi preconditioner is tried, and
    again after a failed line search (config.inner_krylov == "auto").

    Inner tolerance: Eisenstat-Walker choice 2,
    eta_k = 0.9 (||R_k|| / ||R_{k-1}||)^2 clipped to [1e-6, 0.5], 1e-4 on the
    first iteration, unless config.forcing == "fixed" (1e-6).
    """
    log = log or (lambda m: None)
    quirks = config.quirks
    form = config.resolve_formulation("eliminate")
    total = form == "total"
    allow_gmres = config.inner_krylov != "cg"
    n = system.ndof
    if total:
        if t_end is None:
            raise ValueError('formulation "total" needs the step\'s end time')
        F_ext = system.rhs_cumulative(t_end)
        # du's held values: the total ramp value less what u holds already
        mask, ubc = _bc_state(system, system.bc_total_vals(t_end)
                              - aggregate_u[system.bc_dofs])
    else:
        mask, ubc = _bc_state(system, system.bc_step_vals())
    if ops is None:
        ops = matfree_operators(system, config, log)
    el_mv = ops.el_mv
    jacobi_cap = max(200, 4 * int(math.sqrt(n)))

    def residual(du):
        u = aggregate_u + du
        R = el_mv(u if total else du)
        if form == "reference":
            R = R + system.coh_matvec(u, du, quirks)
        R = R - (F_ext + system.coh_force(u, quirks))
        return torch.where(mask, du - ubc, R)

    residual, calls = _counted(residual)

    def pin(du):
        return torch.where(mask, ubc, du)

    def free(v):
        return torch.where(mask, torch.zeros_like(v), v)

    def jacobian(du):
        """The masked J v at du, and its |diagonal| (lazily: only the Jacobi
        path and the GMRES fallback need it)."""
        with timing.span("tangent"):
            ke = system.coh_ke(aggregate_u + du, quirks)
        mv = cg.masked_operator(lambda v: el_mv(v) + system.coh_apply(ke, v),
                                mask)

        def abs_diag():
            d = ops.el_diag + system.coh_diag(aggregate_u + du, quirks)
            d = torch.where(mask, torch.ones_like(d), d)
            return torch.where(d.abs() < 1e-30, torch.ones_like(d), d).abs()

        return mv, abs_diag

    def gmres(mv, rhs, abs_diag, rtol):
        minv = 1.0 / abs_diag()
        return gmres_mod.gmres(mv, rhs, precond=lambda v: minv * v,
                               rtol=rtol, restart=30, maxiter=jacobi_cap)

    def inner_solve(mv, abs_diag, rhs, inner_rtol):
        if ops.mg is None:
            res = cg.pcg(mv, rhs, diag=abs_diag(), rtol=inner_rtol,
                         maxiter=jacobi_cap)
        else:
            res = cg.pcg(mv, rhs, precond=ops.mg.preconditioner(mv),
                         rtol=inner_rtol, maxiter=200)
        delta = free(res.x)
        inner = res.iters
        rhs_norm = max(_norm(rhs), 1e-300)
        rel = _norm(rhs - mv(delta)) / rhs_norm
        used_gmres = False
        if allow_gmres and (not math.isfinite(rel) or rel > 10.0 * inner_rtol
                            or res.indefinite):
            g = gmres(mv, rhs, abs_diag, inner_rtol)
            grel = g.resnorm / rhs_norm
            if math.isfinite(grel) and grel < rel:
                delta = free(g.x)
                used_gmres = True
                inner += g.iters
        return delta, used_gmres, inner

    tw = {"inner": 0.0, "linesearch": 0.0, "residual": 0.0}

    @contextlib.contextmanager
    def timed(name):
        """A span of the run's tree whose seconds this call's log sums."""
        with timing.span(name) as s:
            yield
        tw[name] += s.seconds

    with timed("residual"):
        du = pin(du0)
        R = residual(du)
        rnorm = _norm(R)
    tol = max(config.newton_rtol * rnorm, config.newton_atol)
    log(f"newton: r0={rnorm:.3e} tol={tol:.3e}")
    ew = config.forcing == "ew"
    prev_rnorm = None
    iters = fallbacks = inner_total = 0
    converged = rnorm <= tol
    while not converged and iters < config.newton_maxit:
        if ew and prev_rnorm is not None and prev_rnorm > 0.0:
            inner_rtol = min(0.5, max(1e-6, 0.9 * (rnorm / prev_rnorm) ** 2))
        else:
            inner_rtol = 1e-4 if ew else 1e-6
        with timed("inner"):
            mv, abs_diag = jacobian(du)
            rhs = free(-R)
            delta, used_gmres, n_inner = inner_solve(mv, abs_diag, rhs,
                                                     inner_rtol)
        inner_total += n_inner
        log(f"newton it {iters}: inner done (rtol {inner_rtol:.1e}, "
            f"iters={n_inner}, gmres={used_gmres})")
        with timed("linesearch"):
            best = _line_search(residual, pin, du, delta, rnorm,
                                halvings=20)
            if best is None and not used_gmres and allow_gmres:
                # the CG direction is useless (indefinite tangent past the
                # traction peak): retry with a tight GMRES direction
                g = gmres(mv, rhs, abs_diag, 1e-8)
                inner_total += g.iters
                delta = free(g.x)
                used_gmres = True
                best = _line_search(residual, pin, du, delta, rnorm,
                                    halvings=20)
        if best is None:
            break
        fallbacks += int(used_gmres)
        with timed("residual"):
            lam, du_new, R, r_new = best
            step_norm = _norm(du_new - du)
            du = du_new
            iters += 1
            prev_rnorm, rnorm = rnorm, r_new
            converged = rnorm <= tol or step_norm <= config.newton_stol * max(
                _norm(du), 1e-300)
        log(f"newton it {iters}: rnorm={rnorm:.3e} lam={lam}")
    log("newton wall: inner %.2fs, linesearch %.2fs, residual %.2fs"
        % (tw["inner"], tw["linesearch"], tw["residual"]))
    return NewtonResult(du=du, iters=iters, resnorm=rnorm, converged=converged,
                        gmres_fallbacks=fallbacks, inner_iters=inner_total,
                        residuals=calls[0])
