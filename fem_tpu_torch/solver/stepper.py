"""Incremental quasi-static time stepping — the driver loop, linear branch.

Port of the linear branch of `fem_tpu.solver.stepper.run`. Mirrors
main.F90:216-296: for interval k = 1,2,..., t_init = dt*(k-1) until
t_init >= t; each step forms the time-windowed RHS, solves, and accumulates
aggregate_u += du and aggregate_stress += nodal stress of the increment.
`stype == "explicit"` performs no solve and writes zeros, like the reference
(main.F90:199,238).

The solver path is chosen by one table, PATHS: the first row whose predicate
holds for the problem's features names the path. Rows of paths that are not
ported yet raise NotImplementedError naming their ROADMAP item; later slices
port a path by giving its row a setup function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from fem_tpu_torch.config import Config
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import PENALTY, System
from fem_tpu_torch.ops import structured
from fem_tpu_torch.ops.stiffness import lame
from fem_tpu_torch.solver import cg, direct, multigrid


@dataclasses.dataclass(frozen=True)
class Features:
    """What the path choice reads from a problem and a config."""

    explicit: bool
    cohesive: bool
    creep: bool
    sharded: bool
    solver: str  # "direct" | "cg"
    structured: bool
    precond: str  # "jacobi" | "amg"


# (path name, predicate on Features, ROADMAP item when not ported yet)
PATHS = (
    ("explicit", lambda f: f.explicit, None),
    ("cohesive_newton", lambda f: f.cohesive, "A.7"),
    ("creep", lambda f: f.creep, "A.8"),
    ("sharded", lambda f: f.sharded, "A.9"),
    ("direct", lambda f: f.solver == "direct", None),
    ("structured_mg_cg", lambda f: f.structured, None),
    ("unstructured_amg_or_lattice_gmg_cg", lambda f: f.precond == "amg", "A.6"),
    ("unstructured_jacobi_cg", lambda f: True, None),
)


def choose_path(f: Features) -> str:
    for name, applies, roadmap in PATHS:
        if applies(f):
            if roadmap is not None:
                raise NotImplementedError(
                    f"solver path {name!r} is not ported yet (ROADMAP {roadmap})")
            return name
    raise AssertionError("the last row of PATHS always applies")


@dataclasses.dataclass
class StepResult:
    aggregate_u: np.ndarray  # (ndof,)
    aggregate_stress: np.ndarray  # (nnds, cpdim)
    du: np.ndarray  # last increment
    krylov_iters: List[int]
    nsteps: int
    path: str


def _setup_direct(system: System, config: Config, solver: str, spec, log):
    """Dense LU once; per step a penalty or eliminated RHS."""
    bc_mode = config.resolve_bc_mode(solver)
    bc = system.bc_dofs
    K = system.dense_K()
    kscale = float(K.abs().max())  # physical, pre-penalty
    zero = torch.zeros_like(K[0])
    if bc_mode == "penalty":
        Kb, _ = direct.apply_penalty_bcs(K, zero, bc, system.bc_step_vals(),
                                         PENALTY)
    else:
        Kb, _ = direct.eliminate_bcs(K, zero, bc, system.bc_step_vals())
    fac = direct.factorize(Kb)
    # the reference prints the determinant after every factorization
    # (main.F90:379-390)
    m, e, nn = direct.det_report(fac, ref_scale=kscale)
    log(f"    Direct LU: det(K) = {m:.6f} * 2^{e}"
        + (f", {nn} null pivot(s)" if nn else ""))

    def solve(F, bc_vals, x0):
        if bc_mode == "penalty":
            Fb = F.clone()
            Fb[bc] = PENALTY * bc_vals
        else:
            ubc = torch.zeros_like(F)
            ubc[bc] = bc_vals
            Fb = F - K @ ubc
            Fb[bc] = bc_vals
        return direct.solve_factorized(fac, Fb), None

    return solve


def _setup_structured(system: System, config: Config, solver: str, spec,
                      log):
    """Stencil operator + Chebyshev-smoothed geometric multigrid + PCG in the
    config dtype at every size (fem_tpu's small-deck branch,
    stepper.py:408-467; the H100 has native FP64, so there is no f32 inner
    solve under f64 refinement)."""
    log("    Structured grid detected: stencil + multigrid path")
    dtype, dev = system.dtype, system.device
    lam, mu = lame(torch.tensor(spec["E"], dtype=dtype),
                   torch.tensor(spec["nu"], dtype=dtype))
    op = structured.build(spec["cell_sizes"], spec["node_shape"], lam, mu,
                          dtype=dtype, device=dev)
    hier = multigrid.build(op, system.bc_dofs, smoother="chebyshev")
    bc_mask = torch.zeros(system.ndof, dtype=torch.bool, device=dev)
    bc_mask[system.bc_dofs] = True
    masked = cg.masked_operator(lambda v: structured.matvec(op, v), bc_mask)
    mf = bc_mask.to(dtype)

    def solve(F, bc_vals, x0):
        ubc = torch.zeros_like(F)
        ubc[system.bc_dofs] = bc_vals
        b = cg.constrained_rhs(lambda v: structured.matvec(op, v), F,
                               bc_mask, ubc)
        res = cg.pcg(masked, b, precond=multigrid.preconditioner(hier),
                     rtol=config.rtol or 1e-9, atol=config.atol,
                     maxiter=config.maxiter or 400)
        return res.x * (1.0 - mf) + ubc * mf, res.iters

    return solve


def _setup_jacobi(system: System, config: Config, solver: str, spec, log):
    """Matrix-free System.matvec with Jacobi-PCG, warm-started from the last
    increment (the reference never zeroes Vec_U)."""
    d = system.diag()

    def solve(F, bc_vals, x0):
        res = cg.solve_eliminated(system.matvec, F, d, system.bc_dofs,
                                  bc_vals, x0=x0, rtol=config.rtol,
                                  atol=config.atol, maxiter=config.maxiter)
        return res.x, res.iters

    return solve


_SETUP = {
    "direct": _setup_direct,
    "structured_mg_cg": _setup_structured,
    "unstructured_jacobi_cg": _setup_jacobi,
}


def run(
    problem: Problem,
    config: Optional[Config] = None,
    log: Optional[Callable[[str], None]] = None,
) -> StepResult:
    config = config or Config()
    log = log or (lambda msg: None)
    dtype = config.torch_dtype
    device = config.torch_device()
    n = problem.ndof
    solver = config.resolve_solver(n)
    spec = structured.detect(problem) if solver == "cg" else None
    path = choose_path(Features(
        explicit=problem.stype == "explicit",
        cohesive=problem.has_cohesive,
        creep=config.viscoelastic,
        sharded=bool(config.n_devices and config.n_devices > 1),
        solver=solver,
        structured=spec is not None,
        precond=config.resolve_precond(n),
    ))
    log(f"    Solver path: {path}")
    cpdim = 3 if problem.pdim == 2 else 6
    aggregate_u = torch.zeros(n, dtype=dtype, device=device)
    aggregate_stress = torch.zeros((problem.nnds, cpdim), dtype=dtype,
                                   device=device)
    du = torch.zeros(n, dtype=dtype, device=device)
    krylov_iters: List[int] = []
    nsteps = problem.nsteps

    if path != "explicit":
        system = System(problem, dtype, device=device,
                        plane_stress=config.plane_stress)
        solve = _SETUP[path](system, config, solver, spec, log)
        bc_vals = system.bc_step_vals()
        for k in range(1, nsteps + 1):
            log(f"Interval: {k}")
            F = system.rhs(problem.dt * (k - 1))
            du, iters = solve(F, bc_vals, du)
            if iters is not None:
                krylov_iters.append(int(iters))
            aggregate_u = aggregate_u + du
            aggregate_stress = aggregate_stress + system.stress_increment(du)
    else:
        for k in range(1, nsteps + 1):
            log(f"Interval: {k}")

    return StepResult(
        aggregate_u=aggregate_u.cpu().numpy(),
        aggregate_stress=aggregate_stress.cpu().numpy(),
        du=du.cpu().numpy(),
        krylov_iters=krylov_iters,
        nsteps=nsteps,
        path=path,
    )
