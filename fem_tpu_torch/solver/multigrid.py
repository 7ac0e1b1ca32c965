"""Geometric multigrid V-cycle preconditioner for the stencil operator.

Port of `fem_tpu.solver.multigrid` in one on-device form. CG with a geometric
multigrid preconditioner on the structured grid replaces MUMPS' sparse LU
for large box problems: Chebyshev smoothing by solver/amg._chebyshev (the
recurrence the SA-AMG and lattice-GMG cycles share, at their degree and
interval), trilinear prolongation, its adjoint restriction, re-discretized
coarse operators and a dense coarsest solve, all on the operator's device.
The cycle is a V-cycle: fem_tpu's W-cycle (gamma = 2) took the V-cycle's 12
iterations at 2.67x its wall on the 80^3 box on an NVIDIA H100.

Coarse stencils are re-discretized (lam/mu fields average-pooled), Dirichlet
masks restricted by injection. Grid-shaped (*shape, pdim) state throughout.

Over a device mesh the cycle takes the fine level's K.u as an argument
(`fine_matvec`, the slab-sharded structured.matvec_sharded): the fine level's
smoother and residual then run sharded, and the coarser levels, each about
2^-pdim of the work, where the hierarchy lies (shard 0), as in fem_tpu's
v_cycle_host_sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops import structured
from fem_tpu_torch.solver import amg
from fem_tpu_torch.utils import timing

# Coarsening halves every axis while each cell count is even and its half is
# at least MIN_CELLS, for at most MAX_LEVELS levels.
MIN_CELLS = 2
MAX_LEVELS = 32
# The coarsest level is inverted densely up to COARSE_MAX DOFs. Where
# coarsening stops above that (an odd cell count), a degree-COARSE_DEGREE
# Chebyshev polynomial on the level's interval stands in for the coarse
# solve. fem_tpu takes 40 damped-Jacobi sweeps (omega 0.67) there, which
# diverge where lambda_max(D^-1 A) > 2 / 0.67, as on 3D elastic grids
# (~3.6), and leave its cycle indefinite.
COARSE_MAX = 4096
COARSE_DEGREE = 40


@dataclasses.dataclass(frozen=True)
class MGLevel:
    op: structured.StencilOperator
    dinv: torch.Tensor  # (ndof,) 1 / diag, 1.0 on masked dofs
    maskf: torch.Tensor  # (ndof,) 1.0 on constrained dofs
    # Chebyshev interval [theta - delta, theta + delta] of D^-1 A
    theta: float
    delta: float


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: Tuple[MGLevel, ...]
    # dense inverse of the masked coarsest operator; None above COARSE_MAX
    # DOFs, where the COARSE_DEGREE Chebyshev polynomial stands in
    coarse_inv: Optional[torch.Tensor]


def _pool2(field):
    """Average-pool a per-cell field by 2 along every axis."""
    out = field
    for ax in range(field.dim()):
        n = out.shape[ax]
        lo = [slice(None)] * field.dim()
        hi = list(lo)
        lo[ax] = slice(0, n - 1, 2)
        hi[ax] = slice(1, n, 2)
        out = 0.5 * (out[tuple(lo)] + out[tuple(hi)])
    return out


def _lambda_max_level(op, dinv, maskf, iters: int = 15, seed: int = 0):
    """Power-iteration estimate of lambda_max(D^-1 A_masked), 10% headroom.
    The start vector is np.random.default_rng(seed).standard_normal, as in
    fem_tpu, so theta/delta (and the CG iteration counts) match it."""
    rng = np.random.default_rng(seed)
    x = timing.upload(rng.standard_normal(op.ndof), dtype=op.k_lam.dtype,
                      device=op.k_lam.device)
    x = x / torch.linalg.norm(x)
    keep = 1.0 - maskf
    lam = 1.0
    for _ in range(iters):
        ax = structured.matvec(op, x * keep) * keep + x * maskf
        y = ax * dinv
        ny = torch.linalg.norm(y)
        x = y / ny
        lam = float(ny)
    return 1.1 * lam


def build(op: structured.StencilOperator,
          bc_dofs: torch.Tensor) -> MGHierarchy:
    """Build the hierarchy from the fine stencil operator and the constrained
    dof list. A box element of sizes 2h has k = 2^(pdim-2) k(h), so the
    coarse operators scale the parent's k_lam/k_mu. Each level's D^-1 A
    spectrum is estimated by power iteration; its Chebyshev interval is
    [lambda_max / amg.LB_FRAC, lambda_max]."""
    pdim = op.pdim
    dtype, device = op.k_lam.dtype, op.k_lam.device
    mask = np.zeros(op.ndof, dtype=bool)
    mask[bc_dofs.cpu().numpy()] = True
    mask_grid = mask.reshape(*op.shape, pdim)

    levels = []
    cur_op = op
    cur_mask_grid = mask_grid
    for _ in range(MAX_LEVELS):
        maskf = timing.upload(cur_mask_grid.reshape(-1).astype(np.float64),
                              dtype=dtype, device=device)
        dinv = 1.0 / (structured.diag(cur_op) * (1.0 - maskf) + maskf)
        lam_max = _lambda_max_level(cur_op, dinv, maskf)
        lb = lam_max / amg.LB_FRAC
        levels.append(MGLevel(op=cur_op, dinv=dinv, maskf=maskf,
                              theta=float(0.5 * (lam_max + lb)),
                              delta=float(0.5 * (lam_max - lb))))
        cells = tuple(n - 1 for n in cur_op.shape)
        if any(c % 2 or c // 2 < MIN_CELLS for c in cells):
            break
        scale = 2.0 ** (pdim - 2)
        cur_op = dataclasses.replace(
            cur_op,
            k_lam=cur_op.k_lam * scale,
            k_mu=cur_op.k_mu * scale,
            lam=cur_op.lam if cur_op.lam.dim() == 0 else _pool2(cur_op.lam),
            mu=cur_op.mu if cur_op.mu.dim() == 0 else _pool2(cur_op.mu),
            shape=tuple(c // 2 + 1 for c in cells),
        )
        cur_mask_grid = cur_mask_grid[(slice(None, None, 2),) * pdim]

    # Dense inverse of the masked coarsest operator, its columns formed by the
    # level's own matvec.
    last = levels[-1]
    nc = last.op.ndof
    coarse_inv = None
    if nc <= COARSE_MAX:
        eye = torch.eye(nc, dtype=dtype, device=device)
        K = torch.stack([structured.matvec(last.op, eye[i]) for i in range(nc)],
                        dim=1).cpu().numpy()
        mask_np = last.maskf.cpu().numpy() > 0.5
        K[mask_np, :] = 0.0
        K[:, mask_np] = 0.0
        K[mask_np, mask_np] = 1.0
        coarse_inv = timing.upload(np.linalg.inv(K), dtype=dtype,
                                   device=device)
    return MGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


def _gshape(level: MGLevel):
    return level.op.shape + (level.op.pdim,)


def _masked_matvec_g(level: MGLevel, xg, matvec: Optional[Callable] = None):
    """Masked operator P A P + (I - P) on grid-shaped (*shape, pdim) state;
    `matvec` (flat to flat) stands in for the level's own K.u."""
    mf = level.maskf.reshape(_gshape(level))
    keep = 1.0 - mf
    xk = xg * keep
    ax = (structured.matvec_g(level.op, xk) if matvec is None
          else matvec(xk.reshape(-1)).reshape(xg.shape))
    return ax * keep + xg * mf


def _chebyshev_g(level: MGLevel, xg, bg, matvec=None,
                 degree: int = amg.CHEBYSHEV_DEGREE):
    """amg._chebyshev on the level's interval, grid-shaped state; xg=None is
    a zero initial guess, whose product is skipped."""
    return amg._chebyshev(lambda v: _masked_matvec_g(level, v, matvec),
                          level.dinv.view(bg.shape), level.theta, level.delta,
                          xg, bg, degree)


def _interp_axis(a, axis):
    """1D linear interpolation along `axis`: size m -> 2m-1."""
    m = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = 2 * m - 1
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = 0.5 * (a.narrow(axis, 0, m - 1) + a.narrow(axis, 1, m - 1))
    return out


def _restrict_axis(r, axis):
    """Adjoint of _interp_axis: size 2m-1 -> m."""
    n = r.shape[axis]
    m = (n + 1) // 2
    idx = [slice(None)] * r.dim()
    idx[axis] = slice(0, None, 2)
    out = r[tuple(idx)].clone()
    idx[axis] = slice(1, None, 2)
    half = 0.5 * r[tuple(idx)]
    out.narrow(axis, 0, m - 1).add_(half)
    out.narrow(axis, 1, m - 1).add_(half)
    return out


def prolong_g(xcg, pdim):
    """Coarse (*shape_c, pdim) -> fine (*(2 shape_c - 1), pdim)."""
    for ax in range(pdim):
        xcg = _interp_axis(xcg, ax)
    return xcg


def restrict_g(rfg, pdim):
    """Fine (*shape, pdim) -> coarse (*((shape + 1) / 2), pdim)."""
    for ax in range(pdim):
        rfg = _restrict_axis(rfg, ax)
    return rfg


def v_cycle(h: MGHierarchy, r, fine_matvec: Optional[Callable] = None):
    """One V-cycle on a flat (ndof,) residual; linear and symmetric, so a
    valid CG preconditioner. `fine_matvec` (flat to flat) applies the fine
    level's K.u in place of the level's own operator."""
    return _v_g(h, 0, r.reshape(_gshape(h.levels[0])),
                fine_matvec).reshape(-1)


def _v_g(h: MGHierarchy, idx: int, rg, matvec=None):
    """Level idx of the cycle; `matvec` is this level's K.u when it is not
    the level operator's own (the fine level over a mesh)."""
    level = h.levels[idx]
    if idx == len(h.levels) - 1:
        if h.coarse_inv is None:
            return _chebyshev_g(level, None, rg, matvec, COARSE_DEGREE)
        return (h.coarse_inv @ rg.reshape(-1)).reshape(rg.shape)
    pdim = level.op.pdim
    keep = 1.0 - level.maskf.reshape(rg.shape)
    x = _chebyshev_g(level, None, rg, matvec)
    res = (rg - _masked_matvec_g(level, x, matvec)) * keep
    coarse = h.levels[idx + 1]
    keep_c = 1.0 - coarse.maskf.reshape(_gshape(coarse))
    rc = restrict_g(res, pdim) * keep_c
    xc = _v_g(h, idx + 1, rc) * keep_c
    x = x + prolong_g(xc, pdim)
    return _chebyshev_g(level, x, rg, matvec)


def preconditioner(h: MGHierarchy,
                   fine_matvec: Optional[Callable] = None) -> Callable:
    return lambda r: v_cycle(h, r, fine_matvec)
