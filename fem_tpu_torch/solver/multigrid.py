"""Geometric multigrid V-cycle preconditioner for the stencil operator.

Port of `fem_tpu.solver.multigrid` in one on-device form. CG with a geometric
multigrid preconditioner on the structured grid replaces MUMPS' sparse LU
for large box problems: smoothing (Chebyshev or damped Jacobi), trilinear
prolongation, its adjoint restriction, re-discretized coarse operators and a
dense coarsest solve, all on the operator's device.

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
from fem_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class MGLevel:
    op: structured.StencilOperator
    diag: torch.Tensor  # (ndof,) with 1.0 on masked dofs
    maskf: torch.Tensor  # (ndof,) 1.0 on constrained dofs
    # Chebyshev interval [theta - delta, theta + delta] of D^-1 A; 0.0 for
    # the damped-Jacobi smoother.
    theta: float = 0.0
    delta: float = 0.0


@dataclasses.dataclass(frozen=True)
class MGHierarchy:
    levels: Tuple[MGLevel, ...]
    # dense inverse of the masked coarsest operator; (0, 0) when the coarsest
    # level is too large — then coarse_smooth Jacobi sweeps are used instead
    coarse_inv: torch.Tensor
    nu_pre: int = 2
    nu_post: int = 2
    omega: float = 0.67
    coarse_smooth: int = 0
    # "chebyshev": one degree-`degree` polynomial of D^-1 A per half-cycle
    # instead of nu damped-Jacobi sweeps (~2x fewer 3D MG-CG iterations)
    smoother: str = "jacobi"
    degree: int = 3
    # gamma=2 runs a W-cycle: the coarse correction at every level is applied
    # twice with a residual update in between (B_W = 2B - B A B, symmetric
    # when B is, so still a valid CG preconditioner). The fine level's cost
    # is unchanged; level idx is visited about 2^idx times as often.
    gamma: int = 1


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


def _lambda_max_level(op, diag, maskf, iters: int = 15, seed: int = 0):
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
        y = ax / diag
        ny = torch.linalg.norm(y)
        x = y / ny
        lam = float(ny)
    return 1.1 * lam


def build(op: structured.StencilOperator, bc_dofs: torch.Tensor,
          min_cells: int = 2,
          nu_pre: int = 2, nu_post: int = 2, omega: float = 0.67,
          max_levels: int = 32, smoother: str = "jacobi",
          degree: int = 3, lb_frac: float = 30.0,
          gamma: int = 1) -> MGHierarchy:
    """Build the hierarchy from the fine stencil operator and the constrained
    dof list. Coarsening halves each axis while all cell counts are even and
    > min_cells; a box element of sizes 2h has k = 2^(pdim-2) k(h), so the
    coarse operators scale the parent's k_lam/k_mu. smoother="chebyshev"
    estimates each level's D^-1 A spectrum by power iteration; lb_frac sets
    the interval's lower end, lambda_max / lb_frac. gamma=2 flags the same
    hierarchy for W-cycles (see MGHierarchy.gamma)."""
    pdim = op.pdim
    dtype, device = op.k_lam.dtype, op.k_lam.device
    mask = np.zeros(op.ndof, dtype=bool)
    mask[bc_dofs.cpu().numpy()] = True
    mask_grid = mask.reshape(*op.shape, pdim)

    levels = []
    cur_op = op
    cur_mask_grid = mask_grid
    for _ in range(max_levels):
        maskf = timing.upload(cur_mask_grid.reshape(-1).astype(np.float64),
                              dtype=dtype, device=device)
        d = structured.diag(cur_op)
        d = d * (1.0 - maskf) + maskf
        theta = delta = 0.0
        if smoother == "chebyshev":
            lam_max = _lambda_max_level(cur_op, d, maskf)
            lb = lam_max / lb_frac
            theta = float(0.5 * (lam_max + lb))
            delta = float(0.5 * (lam_max - lb))
        levels.append(MGLevel(op=cur_op, diag=d, maskf=maskf,
                              theta=theta, delta=delta))
        cells = tuple(n - 1 for n in cur_op.shape)
        if any(c % 2 or c // 2 < min_cells for c in cells):
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
    # level's own matvec. If coarsening stopped early (odd cell count) at a
    # level too large to invert densely, heavy Jacobi smoothing stands in.
    last = levels[-1]
    nc = last.op.ndof
    coarse_smooth = 0
    if nc <= 4096:
        eye = torch.eye(nc, dtype=dtype, device=device)
        K = torch.stack([structured.matvec(last.op, eye[i]) for i in range(nc)],
                        dim=1).cpu().numpy()
        mask_np = last.maskf.cpu().numpy() > 0.5
        K[mask_np, :] = 0.0
        K[:, mask_np] = 0.0
        K[mask_np, mask_np] = 1.0
        coarse_inv = timing.upload(np.linalg.inv(K), dtype=dtype,
                                   device=device)
    else:
        coarse_inv = torch.zeros((0, 0), dtype=dtype, device=device)
        coarse_smooth = 40

    return MGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv,
                       nu_pre=nu_pre, nu_post=nu_post, omega=omega,
                       coarse_smooth=coarse_smooth, smoother=smoother,
                       degree=degree, gamma=gamma)


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


def _smooth_g(level: MGLevel, omega, xg, bg, iters: int, matvec=None):
    """`iters` damped-Jacobi sweeps."""
    dg = level.diag.reshape(_gshape(level))
    for _ in range(iters):
        r = bg - _masked_matvec_g(level, xg, matvec)
        xg = xg + omega * r / dg
    return xg


def _cheb_g(level: MGLevel, degree: int, xg, bg, matvec=None):
    """Degree-`degree` Chebyshev smoothing of D^-1 A on the level's
    [theta-delta, theta+delta] interval (solver/amg._chebyshev's recurrence)."""
    dg = level.diag.reshape(_gshape(level))
    theta, delta = level.theta, level.delta
    sigma = theta / delta
    rho = 1.0 / sigma
    r = (bg - _masked_matvec_g(level, xg, matvec)) / dg
    d = r / theta
    for _ in range(degree - 1):
        xg = xg + d
        r = r - _masked_matvec_g(level, d, matvec) / dg
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return xg + d


def _smooth(h: MGHierarchy, level: MGLevel, xg, bg, iters: int, matvec=None):
    if h.smoother == "chebyshev":
        return _cheb_g(level, h.degree, xg, bg, matvec)
    return _smooth_g(level, h.omega, xg, bg, iters, matvec)


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
    """One V(nu_pre, nu_post) cycle (a W-cycle with h.gamma = 2) on a flat
    (ndof,) residual; linear and symmetric, so a valid CG preconditioner.
    `fine_matvec` (flat to flat) applies the fine level's K.u in place of
    the level's own operator."""
    return _v_g(h, 0, r.reshape(_gshape(h.levels[0])),
                fine_matvec).reshape(-1)


def _v_g(h: MGHierarchy, idx: int, rg, matvec=None):
    """Level idx of the cycle; `matvec` is this level's K.u when it is not
    the level operator's own (the fine level over a mesh)."""
    level = h.levels[idx]
    if idx == len(h.levels) - 1:
        if h.coarse_smooth:
            return _smooth_g(level, h.omega, torch.zeros_like(rg), rg,
                             h.coarse_smooth, matvec)
        return (h.coarse_inv @ rg.reshape(-1)).reshape(rg.shape)
    pdim = level.op.pdim
    keep = 1.0 - level.maskf.reshape(rg.shape)
    x = _smooth(h, level, torch.zeros_like(rg), rg, h.nu_pre, matvec)
    res = (rg - _masked_matvec_g(level, x, matvec)) * keep
    coarse = h.levels[idx + 1]
    keep_c = 1.0 - coarse.maskf.reshape(_gshape(coarse))
    rc = restrict_g(res, pdim) * keep_c
    xc = _v_g(h, idx + 1, rc) * keep_c
    if h.gamma >= 2 and idx + 1 < len(h.levels) - 1:
        # W-cycle: one residual-corrected second visit. Skipped when the
        # child is the coarsest level: its dense inverse is exact.
        rc2 = (rc - _masked_matvec_g(coarse, xc)) * keep_c
        xc = xc + _v_g(h, idx + 1, rc2) * keep_c
    x = x + prolong_g(xc, pdim)
    return _smooth(h, level, x, rg, h.nu_post, matvec)


def preconditioner(h: MGHierarchy,
                   fine_matvec: Optional[Callable] = None) -> Callable:
    return lambda r: v_cycle(h, r, fine_matvec)
