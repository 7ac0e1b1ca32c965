"""Geometric block multigrid for lattice-TOPOLOGY meshes: every level a
gather-free block stencil.

Port of the lattice half of `fem_tpu.solver.gmg` (build_lattice and the
grid cycle v_cycle_g). It covers the same role as solver/amg.py (MUMPS'
any-mesh solve, main.F90:354-390) on decks whose assembled connectivity is a
lattice though the geometry is not (jittered, graded, mapped grids).

Coarsening is geometric, by 2 per axis, with kron'd 1D linear interpolation.
For a reach-1 lattice operator A and linear P, the Galerkin product P^T A P
couples coarse nodes i, j only if |i - j| <= 1 per axis, so EVERY coarse
operator is again a 3^d block stencil (ops/blockstencil.py), smoothing at
every level applies shifted windows, and the transfers are the
axis-separable interpolations of solver/multigrid.py, generalized to even
axis sizes. Strength-guided semi-coarsening keeps weak (long-element) axes
at full resolution until RAP levels the anisotropy.

The host builds scipy P / RAP per level (no aggregation, no rigid-body QR);
the device holds block stencils, inverse diagonals and Chebyshev bounds.
The coarsest level is inverted densely (amg._dense_inv). State is node-major
grid-shaped, (*dims, pdim): the flat interleaved vector viewed as the grid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from fem_tpu_torch.ops import blockstencil as bs
from fem_tpu_torch.solver import amg as amg_mod
from fem_tpu_torch.solver import multigrid as mg_mod
from fem_tpu_torch.utils import timing

# largest coarsest level the dense inverse takes
DENSE_COARSE_CAP = 24000
COARSE_MAX = 2400  # coarsening stops at this many DOFs

# ---------------------------------------------------------------------------
# Host-side hierarchy construction
# ---------------------------------------------------------------------------


def _p1d(n: int):
    """1D linear prolongation (n fine rows, ceil(n/2) coarse cols).

    Coarse nodes sit at even fine indices 0, 2, ..; odd fine nodes take
    (1/2, 1/2) from their coarse neighbours. When n is EVEN the last fine
    node (odd index n-1) has no right coarse neighbour and takes weight 1
    from the left, so constant vectors stay exactly representable (rigid
    translations must lie in range(P) for elasticity).
    """
    m = (n + 1) // 2
    rows = [2 * i for i in range(m)]
    cols = list(range(m))
    vals = [1.0] * m
    for i in range(m - 1):
        rows += [2 * i + 1, 2 * i + 1]
        cols += [i, i + 1]
        vals += [0.5, 0.5]
    if n == 2 * m:  # even: weight-1 edge copy
        rows.append(n - 1)
        cols.append(m - 1)
        vals.append(1.0)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _prolongation(dims: Tuple[int, ...], pdim: int, flags=None):
    """P = (P_ax0 kron P_ax1 [kron P_ax2]) kron I_pdim over lex node order
    (axis 0 slowest). flags[ax] False keeps that axis at fine resolution
    (identity factor): semi-coarsening for anisotropic meshes."""

    def fac(ax, d):
        if flags is not None and not flags[ax]:
            return sp.identity(d, format="csr")
        return _p1d(d)

    P = fac(0, dims[0])
    for ax, d in enumerate(dims[1:], start=1):
        P = sp.kron(P, fac(ax, d), format="csr")
    return sp.kron(P, sp.identity(pdim, format="csr"), format="csr")


def _axis_strengths(A, pdim: int, dims: Tuple[int, ...]) -> np.ndarray:
    """Per-axis coupling strength: the sum of the NEGATIVE same-component
    entries -min(a_ij, 0) over face neighbours (node offset exactly +-1
    along the axis, 0 elsewhere), the classic M-matrix strength measure.
    On anisotropic meshes (element aspect 10:1:1) the stretched axis's
    same-component face couplings turn positive (strength -> 0), and
    isotropic coarsening under a point smoother stalls there."""
    offs, Ac = bs._axis_offsets(A, pdim, dims)
    same_comp = (Ac.row % pdim) == (Ac.col % pdim)
    neg = np.maximum(-Ac.data, 0.0)
    n_moved = sum((o != 0).astype(np.int8) for o in offs)
    out = np.zeros(len(dims))
    for ax in range(len(dims)):
        m = (np.abs(offs[ax]) == 1) & (n_moved == 1) & same_comp
        out[ax] = float(neg[m].sum())
    return out


@dataclasses.dataclass(frozen=True)
class GMGLevel:
    # smoothing operator; None on level 0 (the caller's fine matvec is used)
    op: Optional[bs.BlockStencilOperator]
    dinv_g: torch.Tensor  # (*dims, pdim) 1/diag (1.0 where diag == 0)
    theta: float
    delta: float
    dims: Tuple[int, ...]
    # which axes the transfer to the NEXT level coarsens
    coarsen: Tuple[bool, ...]


@dataclasses.dataclass(frozen=True)
class GMGPrecond:
    levels: Tuple[GMGLevel, ...]
    coarse_inv: torch.Tensor  # dense inverse, interleaved (node*pdim+p)
    coarse_dims: Tuple[int, ...]
    pdim: int
    degree: int = 3


def build_lattice(
    A,
    pdim: int,
    dims: Tuple[int, ...],
    bc_dofs=None,
    coarse_max: int = COARSE_MAX,
    dtype=torch.float64,
    device="cpu",
) -> Optional[GMGPrecond]:
    """Build the geometric hierarchy from the assembled scipy CSR `A`
    (BCs not eliminated) whose node numbering is lex over `dims`
    (blockstencil.detect gives dims). Returns None if a Galerkin level
    leaves the lattice (never observed) or if the coarsest level is too
    large to invert densely; the caller then takes SA-AMG."""
    A = A.tocsr()
    if bc_dofs is not None:
        bc = (bc_dofs.cpu().numpy() if torch.is_tensor(bc_dofs)
              else np.asarray(bc_dofs))
        if len(bc):
            A = amg_mod._eliminate_bcs(A, bc)

    levels = []
    cur_A, cur_dims = A, tuple(int(d) for d in dims)
    while (len(levels) < amg_mod.MAX_LEVELS - 1
           and (cur_A.shape[0] > coarse_max or not levels)
           and any(d >= 3 for d in cur_dims)):
        if not bs.offsets_ok(cur_A, pdim, cur_dims):
            return None
        # coarsen the axes whose face couplings are within 4x of the
        # strongest (the classic 0.25 rule)
        can = np.array([d >= 3 for d in cur_dims])
        strengths = _axis_strengths(cur_A, pdim, cur_dims)
        flags = can & (strengths >= 0.25 * strengths[can].max())
        if not flags.any():
            flags = can
        d = cur_A.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
        lam_max = 1.1 * amg_mod._lambda_max(cur_A, dinv)
        lb = lam_max / amg_mod.LB_FRAC
        levels.append(GMGLevel(
            op=(bs.build(cur_A, pdim, cur_dims, dtype=dtype, device=device)
                if levels else None),
            dinv_g=timing.upload(dinv, dtype=dtype, device=device).view(
                *cur_dims, pdim),
            theta=float(0.5 * (lam_max + lb)),
            delta=float(0.5 * (lam_max - lb)),
            dims=cur_dims,
            coarsen=tuple(bool(f) for f in flags),
        ))
        # P is the SAME geometric map prolong_g/restrict_g apply: Galerkin
        # consistency (and so an SPD preconditioner) needs it exactly
        P = _prolongation(cur_dims, pdim, flags)
        cur_A = (P.T.tocsr() @ (cur_A @ P)).tocsr()
        cur_A.sum_duplicates()
        cur_dims = tuple((d + 1) // 2 if f else d
                         for d, f in zip(cur_dims, flags))
    if not levels or cur_A.shape[0] > DENSE_COARSE_CAP:
        return None
    coarse_inv = amg_mod._dense_inv(cur_A.toarray(), device, dtype)
    return GMGPrecond(levels=tuple(levels), coarse_inv=coarse_inv,
                      coarse_dims=cur_dims, pdim=pdim,
                      degree=amg_mod.CHEBYSHEV_DEGREE)


# ---------------------------------------------------------------------------
# Device-side cycle (grid-shaped state (*dims, pdim) at every level)
# ---------------------------------------------------------------------------


def _interp_axis_n(a, axis: int, n_fine: int):
    """multigrid._interp_axis (m -> 2m-1) generalized to EVEN fine sizes:
    2m appends a weight-1 copy of the last coarse value."""
    body = mg_mod._interp_axis(a, axis)
    m = a.shape[axis]
    if n_fine == 2 * m - 1:
        return body
    return torch.cat([body, a.narrow(axis, m - 1, 1)], dim=axis)


def _restrict_axis_n(r, axis: int):
    """Adjoint of _interp_axis_n: size n -> ceil(n/2) for any n."""
    n = r.shape[axis]
    if n % 2 == 1:
        return mg_mod._restrict_axis(r, axis)
    m = n // 2
    out = mg_mod._restrict_axis(r.narrow(axis, 0, n - 1), axis)
    out.narrow(axis, m - 1, 1).add_(r.narrow(axis, n - 1, 1))
    return out


def prolong_g(xc_g, fine_dims: Tuple[int, ...], flags):
    """(*coarse_dims, pdim) -> (*fine_dims, pdim); flags[ax] False leaves
    that axis untouched."""
    a = xc_g
    for ax, n in enumerate(fine_dims):
        if flags[ax]:
            a = _interp_axis_n(a, ax, n)
    return a


def restrict_g(r_g, flags):
    """(*fine_dims, pdim) -> (*coarse_dims, pdim): ceil(n/2) on coarsened
    axes, identity on the rest."""
    a = r_g
    for ax, f in enumerate(flags):
        if f:
            a = _restrict_axis_n(a, ax)
    return a


def v_cycle_g(h: GMGPrecond, fine_matvec_g: Callable, r_g, layout=None):
    """One V-cycle, state (*dims, pdim) at every level; level 0 smooths via
    `fine_matvec_g` (the caller's masked operator on the grid), deeper
    levels via their own block stencils. With `layout` (a
    parallel/mesh.SlabLayout) level 0 is DOF-sharded: r_g, `fine_matvec_g`
    and level 0's dinv_g are ShardedVectors, gathered into the grid for the
    restriction and scattered after the prolongation."""
    return _v(h, 0, fine_matvec_g, r_g, layout)


def _v(h: GMGPrecond, i: int, mv_g: Callable, r_g, layout=None):
    lv = h.levels[i]
    gshape = lv.dims + (h.pdim,)
    down, up = ((lambda v: v,) * 2 if layout is None else
                (lambda v: layout.gather(v).view(gshape),
                 lambda g: layout.scatter(g.reshape(-1))))
    # Chebyshev smoothing on the level's interval, grid-shaped state; x=None
    # is a zero initial guess
    x = amg_mod._chebyshev(mv_g, lv.dinv_g, lv.theta, lv.delta, None, r_g,
                           h.degree)
    rc = restrict_g(down(r_g - mv_g(x)), lv.coarsen)
    if i + 1 == len(h.levels):
        # the grid state flattened is the interleaved dof order
        xc = (h.coarse_inv @ rc.reshape(-1)).view(rc.shape)
    else:
        nxt = h.levels[i + 1]
        xc = _v(h, i + 1,
                lambda v: bs.matvec(nxt.op, v.reshape(-1)).view(v.shape), rc)
    x = x + up(prolong_g(xc, lv.dims, lv.coarsen))
    return amg_mod._chebyshev(mv_g, lv.dinv_g, lv.theta, lv.delta, x, r_g,
                              h.degree)


def preconditioner(h: GMGPrecond, fine_matvec: Callable,
                   layout=None) -> Callable:
    """Flat (ndof,) preconditioner around v_cycle_g; `fine_matvec` is the
    caller's flat masked fine operator. With `layout`, r and `fine_matvec`
    are ShardedVectors (see v_cycle_g)."""
    if layout is not None:
        fine = dataclasses.replace(
            h.levels[0], dinv_g=layout.scatter(h.levels[0].dinv_g.reshape(-1)))
        h = dataclasses.replace(h, levels=(fine,) + h.levels[1:])
        return lambda r: v_cycle_g(h, fine_matvec, r, layout)
    gshape = h.levels[0].dims + (h.pdim,)

    def mv_g(v):
        return fine_matvec(v.reshape(-1)).view(gshape)

    return lambda r: v_cycle_g(h, mv_g, r.view(gshape)).reshape(-1)
