"""Matrix-free preconditioned conjugate gradient, in torch.

Port of `fem_tpu.solver.cg`. Replaces the MUMPS direct factorization
(main.F90:354-390) for large SPD elastic systems. PCG is one host loop over
device work that reads back one residual norm per iteration (the semantics of
fem_tpu's pcg and of its pcg_host_split, which give the same iterates and
counts).

BC handling uses the elimination form, operator-side: constrained dofs map
through the identity and their coupling is masked, keeping the system SPD and
well-conditioned (the 1e30 penalty would destroy CG convergence).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float
    # True when a non-positive curvature p^T A p was met: the operator is
    # indefinite and CG's minimization property is void.
    indefinite: bool = False


def masked_operator(matvec: Callable, bc_mask):
    """Wrap an SPD operator so constrained dofs (bc_mask True) act as
    identity rows/cols: A' = P A P + (I - P), with P the free-dof projector."""

    def op(v):
        mf = bc_mask.to(v.dtype)
        keep = 1.0 - mf
        return matvec(v * keep) * keep + v * mf

    return op


def constrained_rhs(matvec: Callable, F, bc_mask, ubc):
    """RHS for the masked operator: b = P(F - A ubc) + ubc on constrained."""
    mf = bc_mask.to(F.dtype)
    return (F - matvec(ubc)) * (1.0 - mf) + ubc * mf


def pcg(matvec: Callable, b, x0=None, diag=None, rtol: float = 1e-9,
        atol: float = 0.0, maxiter: int = 0,
        precond: Callable = None) -> CGResult:
    """Preconditioned CG. Preconditioner: `precond(r)` if given (e.g. a
    multigrid V-cycle), else Jacobi from `diag`, else identity. Convergence:
    ||r|| <= max(rtol * ||b||, atol) (the PETSc KSP default test with the
    reference's rtol=1e-9, main.F90:349-351). maxiter <= 0 means 10 n. A
    non-finite residual norm ends the iteration (it cannot recover)."""
    if maxiter <= 0:
        maxiter = 10 * b.shape[0]
    if precond is None:
        minv = 1.0 / diag if diag is not None else torch.ones_like(b)
        precond = lambda r: minv * r  # noqa: E731
    tol = max(rtol * float(torch.linalg.norm(b)), atol)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()
    else:
        x = x0.clone()
        r = b - matvec(x0)
    rnorm = float(torch.linalg.norm(r))
    k = 0
    indef = torch.zeros((), dtype=torch.bool, device=b.device)
    if rnorm > tol:
        z = precond(r)
        p = z
        rz = torch.dot(r, z)
        while k < maxiter:
            ap = matvec(p)
            pap = torch.dot(p, ap)
            indef |= pap <= 0.0
            alpha = rz / pap
            x = x + alpha * p
            r = r - alpha * ap
            k += 1
            rnorm = float(torch.linalg.norm(r))  # the one sync per iteration
            if rnorm <= tol or not math.isfinite(rnorm):
                break
            z = precond(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
    return CGResult(x=x, iters=k, resnorm=rnorm, indefinite=bool(indef))


def solve_eliminated(matvec, F, diag, bc_dofs, bc_step_vals, x0=None,
                     rtol=1e-9, atol=0.0, maxiter=0) -> CGResult:
    """One elastic solve with eliminated BCs, Jacobi-preconditioned and
    fully matrix-free."""
    n = F.shape[0]
    bc_mask = torch.zeros(n, dtype=torch.bool, device=F.device)
    bc_mask[bc_dofs] = True
    ubc = torch.zeros_like(F)
    ubc[bc_dofs] = bc_step_vals
    op = masked_operator(matvec, bc_mask)
    b = constrained_rhs(matvec, F, bc_mask, ubc)
    d = torch.where(bc_mask, torch.ones_like(diag), diag)
    if x0 is not None:
        x0 = torch.where(bc_mask, ubc, x0)
    return pcg(op, b, x0=x0, diag=d, rtol=rtol, atol=atol, maxiter=maxiter)
