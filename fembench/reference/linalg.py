"""Plain linear solvers of the reference: Jacobi-preconditioned CG on the
assembled matrix, and a direct block-tridiagonal LU for meshes whose nodes,
taken in the order of one coordinate, couple only within a narrow band.

Dirichlet values are eliminated: the constrained rows and columns become
the identity and their coupling moves to the right-hand side.
"""

from __future__ import annotations

import numpy as np
import torch


class Constrained:
    """K with the dofs `bc_dofs` held: apply(v) is K on the free dofs and the
    identity on the held ones."""

    def __init__(self, K, bc_dofs, n, dtype, device):
        self.K = K
        self.free = torch.ones(n, dtype=dtype, device=device)
        self.free[torch.as_tensor(np.asarray(bc_dofs, np.int64),
                                  device=device)] = 0.0
        held = 1.0 - self.free
        diag = _diagonal(K)
        self.dinv = torch.where(self.free > 0, 1.0 / diag, held)

    def apply(self, v):
        return self.free * (self.K @ (self.free * v)) + (1.0 - self.free) * v

    def rhs(self, F, ubc):
        """Right-hand side of the eliminated system for loads F and held
        values ubc (zero off the held dofs)."""
        return self.free * (F - self.K @ ubc) + (1.0 - self.free) * ubc


def _diagonal(K):
    crow, col, val = K.crow_indices(), K.col_indices(), K.values()
    rows = torch.repeat_interleave(
        torch.arange(K.shape[0], device=val.device), crow[1:] - crow[:-1])
    d = torch.zeros(K.shape[0], dtype=val.dtype, device=val.device)
    return d.index_add_(0, rows[rows == col], val[rows == col])


def pcg(A: Constrained, b, x0, rtol, maxiter, check_every=20, stall=50):
    """Jacobi-preconditioned CG to ||b - A x|| <= rtol ||b||, the residual
    recomputed from x at the end and the iteration restarted from there
    while it is above the tolerance. It also stops where `stall` checks in
    a row bring no new least residual (the dtype's floor, below rtol).
    Returns (x, iterations)."""
    x = x0.clone()
    bnorm = float(torch.linalg.norm(b))
    total, stalled = 0, False
    while True:
        r = b - A.apply(x)
        if (float(torch.linalg.norm(r)) <= rtol * bnorm or stalled
                or total >= maxiter):
            return x, total
        z = A.dinv * r
        p = z.clone()
        rz = torch.dot(r, z)
        best, since = float("inf"), 0
        for k in range(1, maxiter - total + 1):
            Ap = A.apply(p)
            alpha = rz / torch.dot(p, Ap)
            x += alpha * p
            r -= alpha * Ap
            if k % check_every == 0:
                rn = float(torch.linalg.norm(r))
                if rn <= rtol * bnorm:
                    break
                best, since = (rn, 0) if rn < best else (best, since + 1)
                if since >= stall:
                    stalled = True
                    break
            z = A.dinv * r
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        total += k


def band_order(coords, pdim, axis=0):
    """Dofs ordered by the nodes' coordinate along `axis`, then the others:
    on a strip this gives K a band of about two node columns."""
    keys = [coords[:, d] for d in reversed(range(coords.shape[1]))
            if d != axis] + [coords[:, axis]]
    nodes = np.lexsort(keys)
    return (nodes[:, None] * pdim + np.arange(pdim)).reshape(-1)


def block_tridiagonal_solve(A: Constrained, b, order, refine=2):
    """Direct solve of A x = b, A taken in the dof order `order` and cut into
    square blocks as wide as its band, so that only the diagonal and the two
    next block diagonals hold entries: block LU without pivoting between
    blocks (LU with partial pivoting inside each), then `refine` steps of
    iterative refinement in the same dtype."""
    n = b.shape[0]
    dev, dt = b.device, b.dtype
    perm = torch.as_tensor(order, device=dev)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    K = A.K
    crow = K.crow_indices()
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   crow[1:] - crow[:-1])
    cols, vals = K.col_indices(), K.values()
    keep = (A.free[rows] > 0) & (A.free[cols] > 0)
    r, c, v = pos[rows[keep]], pos[cols[keep]], vals[keep]
    held = pos[torch.nonzero(A.free == 0).reshape(-1)]
    r = torch.cat([r, held])
    c = torch.cat([c, held])
    v = torch.cat([v, torch.ones(held.shape[0], dtype=dt, device=dev)])
    w = int((r - c).abs().max()) + 1
    nb = -(-n // w)
    # pad to nb * w with identity rows
    pad = torch.arange(n, nb * w, device=dev)
    r, c = torch.cat([r, pad]), torch.cat([c, pad])
    v = torch.cat([v, torch.ones(pad.shape[0], dtype=dt, device=dev)])
    bi, bj = r // w, c // w
    diag = torch.zeros((nb, w, w), dtype=dt, device=dev)
    lower = torch.zeros((nb, w, w), dtype=dt, device=dev)  # block (k, k-1)
    upper = torch.zeros((nb, w, w), dtype=dt, device=dev)  # block (k, k+1)
    for blocks, sel in ((diag, bi == bj), (lower, bi == bj + 1),
                        (upper, bi + 1 == bj)):
        blocks.index_put_((bi[sel], r[sel] % w, c[sel] % w), v[sel],
                          accumulate=True)
    # block Thomas: S_k = D_k - L_k S_{k-1}^-1 U_{k-1}
    lus, gains = [], []
    for k in range(nb):
        S = diag[k]
        if k:
            S = S - lower[k] @ gains[-1]
        lus.append(torch.linalg.lu_factor_ex(S)[:2])
        if k + 1 < nb:
            gains.append(torch.linalg.lu_solve(*lus[-1], upper[k]))

    def solve(rhs):
        y = torch.zeros(nb * w, dtype=dt, device=dev)
        y[:n] = rhs[perm]
        y = y.reshape(nb, w, 1)
        out = torch.empty_like(y)
        for k in range(nb):
            rk = y[k] - (lower[k] @ out[k - 1] if k else 0.0)
            out[k] = torch.linalg.lu_solve(*lus[k], rk)
        for k in range(nb - 2, -1, -1):
            out[k] = out[k] - gains[k] @ out[k + 1]
        x = torch.empty(n, dtype=dt, device=dev)
        x[perm] = out.reshape(-1)[:n]
        return x

    x = solve(b)
    for _ in range(refine):
        x = x + solve(b - A.apply(x))
    return x
