"""Restarted GMRES(m), right-preconditioned, in torch.

Port of `fem_tpu.solver.gmres`. It completes the Krylov family next to CG
(solver/cg.py): the reference's KSP defaults to GMRES when it is not forced to
MUMPS (the commented alternative in main.F90:392-394 is gmres+asm), and the
cohesive tangent loses symmetry under `quirks` and definiteness past the
traction peak, where CG does not apply.

Modified Gram-Schmidt builds the Arnoldi basis on the device; Givens
rotations reduce the Hessenberg matrix to triangular form one column at a
time on the host, so each iteration reads back one small vector (its new
Hessenberg column) and knows its residual estimate |g_{j+1}|. The loop stops
at convergence, so `iters` counts the inner iterations actually done, and a
happy breakdown (an exactly invariant subspace) ends the cycle with a zero
residual estimate instead of a division by zero.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.linalg as sla
import torch

from fem_tpu_torch.utils import timing


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int  # inner iterations over all restarts
    resnorm: float  # true residual norm ||b - A x||


def gmres(
    matvec: Callable,
    b,
    x0=None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-9,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 0,
) -> GMRESResult:
    """Solve A M z = b with x = M z (right preconditioning), so the residual
    the iteration tracks is the true one. Stops when ||b - A x|| <=
    max(rtol ||b||, atol) or after ceil(maxiter / restart) cycles
    (maxiter <= 0 means 10 n)."""
    n = b.shape[0]
    if maxiter <= 0:
        maxiter = 10 * n
    if precond is None:
        precond = lambda v: v  # noqa: E731
    m = min(restart, n)
    max_cycles = -(-maxiter // m)
    tol = max(rtol * float(torch.linalg.norm(b)), atol)
    eps = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b) if x0 is None else x0.clone()

    def cycle(x):
        r = b - matvec(x)
        beta = float(torch.linalg.norm(r))
        V = [r / beta if beta > eps else torch.zeros_like(r)]
        R = np.zeros((m, m))  # the triangularized Hessenberg matrix
        g = np.zeros(m + 1)
        g[0] = beta
        cs, sn = [], []
        res, k = beta, 0
        while k < m and res > tol:
            j = k
            w = matvec(precond(V[j]))
            hs = []
            for i in range(j + 1):  # modified Gram-Schmidt
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                hs.append(hij)
            hs.append(torch.linalg.norm(w))
            h = torch.stack(hs).tolist()  # the one read-back per iteration
            hnext = h[j + 1]
            for i in range(j):  # previous rotations
                h[i], h[i + 1] = (cs[i] * h[i] + sn[i] * h[i + 1],
                                  -sn[i] * h[i] + cs[i] * h[i + 1])
            denom = math.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            c_j, s_j = (h[j] / denom, h[j + 1] / denom) if denom > eps else (
                1.0, 0.0)
            R[: j + 1, j] = h[:j] + [denom]
            g[j + 1] = -s_j * g[j]
            g[j] = c_j * g[j]
            cs.append(c_j)
            sn.append(s_j)
            res = abs(g[j + 1])
            k += 1
            V.append(w / hnext if hnext > eps else torch.zeros_like(w))
        if k:
            Rk = R[:k, :k].copy()
            # an exactly zero pivot (breakdown with denom == 0) gets a unit
            # one; its rhs entry is already 0
            dg = np.diag(Rk).copy()
            np.fill_diagonal(Rk, np.where(np.abs(dg) > eps, dg, 1.0))
            y = sla.solve_triangular(Rk, g[:k], lower=False)
            basis = torch.stack(V[:k], dim=1)  # (n, k)
            x = x + precond(basis @ timing.upload(y, dtype=b.dtype,
                                                  device=b.device))
        return x, float(torch.linalg.norm(b - matvec(x))), k

    rnorm = float(torch.linalg.norm(b - matvec(x)))
    iters = cycles = 0
    while rnorm > tol and cycles < max_cycles:
        x, rnorm, k = cycle(x)
        iters += k
        cycles += 1
    return GMRESResult(x=x, iters=iters, resnorm=rnorm)
