"""Mixed-precision iterative refinement: float64 accuracy from a float32
inner solve.

Port of `fem_tpu.solver.mixed.ir_solve` as one plain torch loop:

  outer (f64): r_k = b - A x_k          one float64 matvec per cycle
  inner (f32): solve A d = r_k approximately (PCG, ~1e-4 reduction)
  update:      x_{k+1} = x_k + d

Each cycle multiplies the true residual by the inner reduction factor, so a
few cycles reach the reference's 1e-9 (main.F90:349-351). fem_tpu needs this
because a TPU emulates float64; the H100 has native float64 and no stepper
row calls this function (`stepper._setup_structured` gives the measurement).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fem_tpu_torch.ops import operator as op_mod
from fem_tpu_torch.solver import cg


class IRResult(NamedTuple):
    x: torch.Tensor  # float64 solution
    outer_iters: int
    inner_iters: int  # total float32 CG iterations
    resnorm: float  # true float64 residual norm


def ir_solve(op64, op32, F, diag32, bc_dofs, bc_vals, rtol: float = 1e-9,
             atol: float = 0.0, inner_rtol: float = 1e-4,
             inner_maxiter: int = 2000, outer_maxiter: int = 40,
             apply: Callable = op_mod.matvec,
             precond32: Optional[Callable] = None) -> IRResult:
    """Solve K x = F with eliminated Dirichlet BCs to float64 accuracy.

    op64/op32: the same operator in both precisions (FusedOperator.astype,
    StencilOperator.astype). `apply(op, v)` is the raw K @ v; pass
    ops.structured.matvec for the stencil operator. F: float64 load vector.
    diag32: float32 Jacobi diagonal (bc rows arbitrary). precond32: optional
    float32 preconditioner (e.g. a multigrid V-cycle) in place of Jacobi.
    """
    n = F.shape[0]
    bc_mask = torch.zeros(n, dtype=torch.bool, device=F.device)
    bc_mask[bc_dofs] = True
    ubc = torch.zeros_like(F)
    ubc[bc_dofs] = bc_vals

    A64 = cg.masked_operator(lambda v: apply(op64, v), bc_mask)
    b = cg.constrained_rhs(lambda v: apply(op64, v), F, bc_mask, ubc)
    A32 = cg.masked_operator(lambda v: apply(op32, v), bc_mask)
    d32 = torch.where(bc_mask, torch.ones_like(diag32), diag32).float()
    tol = max(rtol * float(torch.linalg.norm(b)), atol)

    x = ubc
    r = b - A64(x)
    rnorm = float(torch.linalg.norm(r))
    k = inner_total = 0
    while rnorm > tol and k < outer_maxiter:
        res = cg.pcg(A32, r.float(), diag=d32, rtol=inner_rtol,
                     maxiter=inner_maxiter, precond=precond32)
        # pinned dofs stay exact (the correction is ~0 there by construction
        # of the masked operator; enforced against drift)
        x = torch.where(bc_mask, ubc, x + res.x.to(x.dtype))
        r = b - A64(x)
        rnorm = float(torch.linalg.norm(r))
        k += 1
        inner_total += res.iters
    return IRResult(x=x, outer_iters=k, inner_iters=inner_total,
                    resnorm=rnorm)
