"""Smoothed-aggregation AMG preconditioner for unstructured meshes.

Port of `fem_tpu.solver.amg`. The reference solves ANY mesh with MUMPS'
sparse direct LU (main.F90:354-390); for large unstructured meshes, where
geometric coarsening does not exist, smoothed aggregation (Vanek, Mandel,
Brezina '96) builds the hierarchy algebraically from the assembled matrix and
the elastic rigid-body modes.

Division of labour:
  - SET-UP on the host in numpy/scipy: sparse assembly (element stiffnesses
    from kernel K1 on a CUDA device), strength graph, greedy aggregation,
    per-aggregate rank-revealing QR of the rigid-body modes, prolongator
    smoothing, Galerkin triple products, power iteration. Every sparse table
    the cycle reads is then laid out once as a CSR table (`Csr`).
  - The CYCLE on the device: Chebyshev smoothing, sparse products through
    kernel K3 (`cuda_kernels.csr_matvec`) for the prolongation P, the
    restriction R = P^T (a CSR over coarse rows) and the mid-level
    operators, and a dense coarsest inverse (Cholesky on the device).
    The cycle is differentiable there: K3's backward in x is K3 on the
    table's transpose, which each P and R holds in the other.

The preconditioner is symmetric positive definite (same-degree Chebyshev
pre/post smoothing, adjoint transfers, Galerkin coarse operators), so it is a
valid CG preconditioner. BC dofs are eliminated before set-up (identity
rows/cols) to match cg.masked_operator's fine-level convention.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.ops import stiffness as stiff_ops
from fem_tpu_torch.utils import timing

MAX_LEVELS = 10
CHEBYSHEV_DEGREE = 3
# levels whose node graph has more nodes than this coarsen aggressively
# (aggregates over the squared graph: the next level ~5x smaller)
AGGRESSIVE_THRESHOLD = 10000
# Chebyshev interval [lambda_max / LB_FRAC, lambda_max] of D^-1 A
LB_FRAC = 30.0

# ---------------------------------------------------------------------------
# Host-side set-up
# ---------------------------------------------------------------------------


def assemble_csr(system) -> sp.csr_matrix:
    """Assemble the elastic stiffness as a scipy CSR matrix (float64) on the
    host. Replaces the reference's MatSetValues/MatAssembly scatter
    (main.F90:157-171).

    Element matrices come from stiffness.element_stiffness_lame on the
    system's device (kernel K1 for hex8 on a CUDA device), in float64. The
    assembly then runs at NODE-BLOCK granularity: elasticity couples full
    pdim x pdim blocks per node pair, so sorting node-pair codes touches
    pdim^2 fewer indices than a scalar COO->CSR, the duplicate blocks
    collapse in one np.add.reduceat, and the block rows expand to scalar CSR
    through scipy's bsr_tocsr.
    """
    pdim = system.pdim
    nnds = system.ndof // pdim
    brows: List[np.ndarray] = []
    bcols: List[np.ndarray] = []
    blocks: List[np.ndarray] = []
    for e in system.blocks.values():
        f64 = torch.float64
        lam, mu = stiff_ops.lame(e["E"].to(f64), e["nu"].to(f64))
        ke = stiff_ops.element_stiffness_lame(
            e["et"], e["ecoords"].to(f64), lam, mu).cpu().numpy()
        conn = e["conn"].cpu().numpy()  # (ne, nn)
        ne, nn = conn.shape
        # ke is interleaved node-major ((n0_x, n0_y, ...), element dofs)
        # -> (ne, nn, nn, pdim, pdim) node-pair blocks
        kb = ke.reshape(ne, nn, pdim, nn, pdim).transpose(0, 1, 3, 2, 4)
        del ke
        brows.append(np.broadcast_to(conn[:, :, None], (ne, nn, nn)).reshape(-1))
        bcols.append(np.broadcast_to(conn[:, None, :], (ne, nn, nn)).reshape(-1))
        blocks.append(np.ascontiguousarray(kb).reshape(-1, pdim, pdim))
    codes = np.concatenate(brows) * nnds + np.concatenate(bcols)
    del brows, bcols
    blk = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
    del blocks
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    starts = np.flatnonzero(np.r_[True, codes[1:] != codes[:-1]])
    ublk = np.add.reduceat(blk[order], starts, axis=0)
    del blk, order
    ucodes = codes[starts]
    urows = ucodes // nnds
    ucols = (ucodes % nnds).astype(np.int32)
    indptr = np.zeros(nnds + 1, dtype=np.int64)
    np.cumsum(np.bincount(urows, minlength=nnds), out=indptr[1:])
    n = system.ndof
    A = sp.bsr_matrix((ublk, ucols, indptr), shape=(n, n),
                      blocksize=(pdim, pdim))
    return A.tocsr()


def _eliminate_bcs(A, bc_dofs):
    """Zero constrained rows/cols, unit diagonal (cg.masked_operator form)."""
    n = A.shape[0]
    keep = np.ones(n)
    keep[bc_dofs] = 0.0
    D = sp.diags(keep)
    ones = sp.coo_matrix(
        (np.ones(len(bc_dofs)), (bc_dofs, bc_dofs)), shape=(n, n)
    )
    A = (D @ A @ D + ones).tocsr()
    A.sum_duplicates()
    return A


def rigid_body_modes(coords, pdim, bc_dofs=None):
    """Near-nullspace B (ndof x nb): translations + rotations, zeroed on
    constrained dofs. nb = 3 (2D) or 6 (3D)."""
    nn = coords.shape[0]
    x = coords[:, 0]
    y = coords[:, 1]
    if pdim == 2:
        B = np.zeros((nn * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -y
        B[1::2, 2] = x
    else:
        z = coords[:, 2]
        B = np.zeros((nn * 3, 6))
        for d in range(3):
            B[d::3, d] = 1.0
        B[0::3, 3] = -y
        B[1::3, 3] = x
        B[1::3, 4] = -z
        B[2::3, 4] = y
        B[0::3, 5] = z
        B[2::3, 5] = -x
    if bc_dofs is not None and len(bc_dofs):
        B[np.asarray(bc_dofs)] = 0.0
    return B


def _node_graph(A, dof_node, nnodes):
    """Condense |A| onto the node partition given by dof_node (len ndof)."""
    n = A.shape[0]
    R = sp.csr_matrix(
        (np.ones(n), (dof_node, np.arange(n))), shape=(nnodes, n)
    )
    N = (R @ abs(A) @ R.T).tocsr()
    N.setdiag(0.0)
    N.eliminate_zeros()
    return N


def _aggregate(N):
    """Standard greedy aggregation on the node graph N (CSR, no diagonal).

    Three passes (Vanek et al.): (1) a node whose neighbourhood is untouched
    seeds an aggregate with all its neighbours; (2) leftover nodes join the
    neighbouring aggregate with the strongest connection; (3) remaining
    connected leftovers seed aggregates from what is left. Isolated nodes
    (e.g. fully constrained: their matrix rows are identity) stay
    unaggregated and carry no coarse dofs.
    """
    n = N.shape[0]
    indptr, indices, data = N.indptr, N.indices, N.data
    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) == 0:
            continue  # isolated
        if np.all(agg[nbrs] == -1):
            agg[i] = na
            agg[nbrs] = na
            na += 1
    # pass 2: join the strongest neighbouring aggregate
    unassigned = np.nonzero(agg == -1)[0]
    joined = agg.copy()
    for i in unassigned:
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi]
        w = data[lo:hi]
        mask = agg[nbrs] >= 0
        if np.any(mask):
            joined[i] = agg[nbrs[mask][np.argmax(w[mask])]]
    agg = joined
    # pass 3: aggregate the remaining connected nodes among themselves
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) == 0:
            continue
        agg[i] = na
        free = nbrs[agg[nbrs] == -1]
        agg[free] = na
        na += 1
    return agg, na


def _tentative(agg, naggs, dof_node, B):
    """Tentative prolongator + coarse candidate modes via per-aggregate
    rank-revealing QR of B. Returns (P0 csr, B_c, dof_node_c)."""
    ndof = B.shape[0]
    nb = B.shape[1]
    dof_agg = np.where(dof_node >= 0, agg[dof_node], -1)
    order = np.argsort(dof_agg, kind="stable")
    sorted_agg = dof_agg[order]
    start = np.searchsorted(sorted_agg, np.arange(naggs), side="left")
    end = np.searchsorted(sorted_agg, np.arange(naggs), side="right")

    rowsP: List[np.ndarray] = []
    colsP: List[np.ndarray] = []
    valsP: List[np.ndarray] = []
    Bc_rows: List[np.ndarray] = []
    dof_node_c: List[np.ndarray] = []
    nc = 0
    for g in range(naggs):
        idx = order[start[g]:end[g]]
        if len(idx) == 0:
            continue
        Bg = B[idx]  # (m, nb)
        if not np.any(Bg):
            continue
        Q, R, _ = sla.qr(Bg, mode="economic", pivoting=True)
        d = np.abs(np.diag(R))
        if d.size == 0 or d[0] == 0.0:
            continue
        rank = int(np.sum(d > max(Bg.shape) * np.finfo(float).eps * d[0]))
        if rank == 0:
            continue
        Qg = Q[:, :rank]  # (m, rank)
        rowsP.append(np.repeat(idx, rank))
        colsP.append(np.tile(nc + np.arange(rank), len(idx)))
        valsP.append(Qg.reshape(-1))
        Bc_rows.append(Qg.T @ Bg)  # (rank, nb)
        dof_node_c.append(np.full(rank, g, dtype=np.int64))
        nc += rank
    if not rowsP:
        return sp.csr_matrix((ndof, 0)), np.zeros((0, nb)), np.zeros(0, np.int64)
    P0 = sp.csr_matrix(
        (np.concatenate(valsP), (np.concatenate(rowsP), np.concatenate(colsP))),
        shape=(ndof, nc),
    )
    return P0, np.vstack(Bc_rows), np.concatenate(dof_node_c)


def _lambda_max(A, dinv, iters=30, seed=0):
    """Power-iteration estimate of lambda_max(D^-1 A)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if ny == 0.0:
            return 1.0
        lam = ny
        x = y / ny
    return float(lam)


def _dense_inv(Kc, device, dtype=torch.float64):
    """Dense inverse of the coarsest SPD operator: Cholesky + cholesky_inverse
    in float64 on `device`, returned in `dtype` there. Raises when K is not
    positive definite (there is no fallback)."""
    K = timing.upload(Kc, dtype=torch.float64, device=device)
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0:
        raise RuntimeError(
            f"coarse operator of size {K.shape[0]} is not positive definite "
            f"(Cholesky failed at column {int(info)})")
    X = torch.cholesky_inverse(L)
    return (0.5 * (X + X.T)).to(dtype)


# ---------------------------------------------------------------------------
# Device-side hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Csr:
    """A sparse table as kernel K3 reads it: CSR without padding, and the
    number of threads that share a row, chosen from the mean row length
    when the table is built."""

    indptr: torch.Tensor  # (n + 1,) int64
    indices: torch.Tensor  # (nnz,) int32
    data: torch.Tensor  # (nnz,)
    ncols: int
    lanes: int
    # the table of A^T, once formed or linked (link_transposes); a copy
    # made with dataclasses.replace starts without one
    _t: Optional["Csr"] = dataclasses.field(default=None, init=False,
                                            repr=False, compare=False)

    @classmethod
    def from_csr(cls, A, dtype, device) -> "Csr":
        """From a scipy sparse matrix."""
        A = A.tocsr()
        return cls(timing.upload(A.indptr, dtype=torch.int64, device=device),
                   timing.upload(A.indices, dtype=torch.int32, device=device),
                   timing.upload(A.data, dtype=dtype, device=device),
                   int(A.shape[1]), cuda_kernels.csr_lanes(A.shape[0], A.nnz))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.indptr.shape[0] - 1, self.ncols

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.data.cpu().numpy(),
                              self.indices.cpu().numpy(),
                              self.indptr.cpu().numpy()), shape=self.shape)

    def transposed(self) -> "Csr":
        """The table of A^T, which K3's backward in x runs: formed once on
        the table's device (cuda_kernels.csr_transpose), the first time it
        is asked for, then kept. The SA-AMG hierarchy links each P and
        R = P^T to each other (link_transposes), so that neither is formed."""
        if self._t is None:
            indptr, indices, data, lanes = cuda_kernels.csr_transpose(
                self.indptr, self.indices, self.data, self.ncols)
            object.__setattr__(self, "_t", Csr(indptr, indices, data,
                                               self.shape[0], lanes))
        return self._t

    def __call__(self, x):
        if x.shape != (self.ncols,):
            raise ValueError(f"x must be ({self.ncols},), got {tuple(x.shape)}")
        return cuda_kernels.csr_matvec(self.indptr, self.indices, self.data, x,
                                       self.lanes, self.transposed)


def link_transposes(P: Csr, R: Csr) -> None:
    """Keep R as P's transposed table and P as R's (R = P^T exactly)."""
    object.__setattr__(P, "_t", R)
    object.__setattr__(R, "_t", P)


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    # the level's operator on mid levels: a densified (n, n) matrix when
    # n <= dense_level_max, else a CSR table. None on level 0 (the caller's
    # fine matvec is used there) and on the coarsest (its dense inverse is)
    op: Optional[Csr]
    dense_op: Optional[torch.Tensor]
    dinv: torch.Tensor  # (n,) 1/diag (1.0 on constrained dofs)
    # prolongation P (fine <- coarse, over fine rows) and restriction
    # R = P^T (over coarse rows); None on the coarsest level
    P: Optional[Csr]
    R: Optional[Csr]
    # Chebyshev interval [theta - delta, theta + delta] of D^-1 A
    theta: float
    delta: float
    n_coarse: int


@dataclasses.dataclass(frozen=True)
class AMGPrecond:
    levels: Tuple[AMGLevel, ...]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    degree: int = 3


def build(
    system,
    bc_dofs,
    coarse_max: int = 1200,
    A=None,
    dense_level_max: int = 8192,
    coords=None,
) -> AMGPrecond:
    """Build the SA-AMG hierarchy for a System's elastic operator. The set-up
    runs on the host; the hierarchy's tensors live on the system's device in
    its dtype. Coarsening stops at `coarse_max` DOFs (the coarsest level is
    inverted densely); mid levels of at most `dense_level_max` DOFs are
    stored dense, larger ones as CSR tables. `A` may be a pre-assembled
    scipy CSR (BCs NOT yet eliminated) to skip re-assembly; with `coords`
    (the node coordinates in A's node order, for the rigid-body modes) it
    may be numbered otherwise than the system, `bc_dofs` in its numbering."""
    dtype, device = system.dtype, system.device
    if A is None:
        A = assemble_csr(system)
    bc = (bc_dofs.cpu().numpy() if torch.is_tensor(bc_dofs)
          else np.asarray(bc_dofs))
    A = _eliminate_bcs(A, bc)
    coords = np.asarray(system.problem.coords if coords is None else coords)
    pdim = system.pdim
    B = rigid_body_modes(coords, pdim, bc)
    ndof = A.shape[0]
    dof_node = np.arange(ndof) // pdim
    nnodes = coords.shape[0]

    def dev(a):
        return timing.upload(a, dtype=dtype, device=device)

    levels: List[AMGLevel] = []
    level_A = A
    while len(levels) < MAX_LEVELS - 1 and level_A.shape[0] > coarse_max:
        d = level_A.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
        lam_max = 1.1 * _lambda_max(level_A, dinv)
        N = _node_graph(level_A, dof_node, nnodes)
        if N.shape[0] > AGGRESSIVE_THRESHOLD:
            N2 = (N @ N + N).tocsr()
            N2.setdiag(0.0)
            N2.eliminate_zeros()
            N = N2
        agg, naggs = _aggregate(N)
        P0, B_c, dof_node_c = _tentative(agg, naggs, dof_node, B)
        if P0.shape[1] == 0 or P0.shape[1] >= level_A.shape[0]:
            break
        # smoothed prolongator: P = (I - omega D^-1 A) P0, D^-1 A as a row
        # scaling of A's data
        omega = (4.0 / 3.0) / lam_max
        row_of = np.repeat(np.arange(level_A.shape[0]), np.diff(level_A.indptr))
        DinvA = sp.csr_matrix(
            (level_A.data * dinv[row_of], level_A.indices, level_A.indptr),
            shape=level_A.shape)
        P = (P0 - omega * (DinvA @ P0)).tocsr()
        P.sum_duplicates()
        # Galerkin RAP with an explicit CSR restriction
        R = P.T.tocsr()
        A_c = (R @ (level_A @ P)).tocsr()
        A_c.sum_duplicates()

        op, dense_op = None, None
        if levels and level_A.shape[0] <= dense_level_max:
            dense_op = dev(level_A.toarray())
        elif levels:
            op = Csr.from_csr(level_A, dtype, device)
        lb = lam_max / LB_FRAC
        P_t = Csr.from_csr(P, dtype, device)
        R_t = Csr.from_csr(R, dtype, device)
        link_transposes(P_t, R_t)
        levels.append(AMGLevel(
            op=op, dense_op=dense_op, dinv=dev(dinv), P=P_t, R=R_t,
            theta=float(0.5 * (lam_max + lb)),
            delta=float(0.5 * (lam_max - lb)),
            n_coarse=int(P.shape[1]),
        ))
        level_A = A_c
        B = B_c
        dof_node = dof_node_c
        nnodes = naggs

    # coarsest level: dense inverse, zero rows pinned to the identity
    d = level_A.diagonal()
    dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    Kc = level_A.toarray()
    zero_rows = np.abs(Kc).sum(axis=1) == 0.0
    if np.any(zero_rows):
        Kc[zero_rows, zero_rows] = 1.0
    coarse_inv = _dense_inv(Kc, device, dtype)
    del Kc
    levels.append(AMGLevel(
        op=None, dense_op=None, dinv=dev(dinv), P=None, R=None,
        theta=1.0, delta=0.5, n_coarse=0,
    ))
    return AMGPrecond(levels=tuple(levels), coarse_inv=coarse_inv,
                      degree=CHEBYSHEV_DEGREE)


def ell_to_csr(vals_nw, cols_nw, ncols) -> sp.csr_matrix:
    """fem_tpu's row-major (n, w) ELL table as a scipy CSR matrix; its
    padded slots (value 0) are dropped."""
    vals = np.asarray(vals_nw)
    n, w = vals.shape
    A = sp.csr_matrix((vals.reshape(-1), (np.repeat(np.arange(n), w),
                                          np.asarray(cols_nw).reshape(-1))),
                      shape=(n, ncols))
    A.eliminate_zeros()
    return A


def from_reference(h, dtype=torch.float64, device="cpu") -> AMGPrecond:
    """The port's hierarchy from `fem_tpu.solver.amg.AMGPrecond` `h` (any
    array type numpy can read): the same levels, operators, transfers,
    Chebyshev bounds and coarse inverse, in the port's layouts. The
    counterpart of Problem.from_reference, so the two cycles can be compared
    on the very same hierarchy."""

    def dev(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def csr(vals_nw, cols_nw, ncols):
        return Csr.from_csr(ell_to_csr(vals_nw, cols_nw, ncols), dtype, device)

    levels = []
    for lv in h.levels:
        dense = np.asarray(lv.dense_op)
        ev = np.asarray(lv.ell_vals)
        P = R = None
        if lv.n_coarse:
            P = csr(lv.p_vals, lv.p_cols, lv.n_coarse)
            n_fine = np.asarray(lv.dinv).shape[0]
            Rt = sp.csr_matrix(
                (np.asarray(lv.pt_vals), (np.asarray(lv.pt_coarse),
                                          np.asarray(lv.pt_fine))),
                shape=(lv.n_coarse, n_fine))
            R = Csr.from_csr(Rt, dtype, device)
            link_transposes(P, R)
        levels.append(AMGLevel(
            op=(csr(ev, lv.ell_cols, ev.shape[0])
                if ev.shape[0] and lv.n_coarse else None),
            dense_op=dev(dense) if dense.shape[0] else None,
            dinv=dev(lv.dinv), P=P, R=R, theta=float(lv.theta),
            delta=float(lv.delta), n_coarse=int(lv.n_coarse),
        ))
    return AMGPrecond(levels=tuple(levels), coarse_inv=dev(h.coarse_inv),
                      degree=int(h.degree))


# ---------------------------------------------------------------------------
# Device-side cycle
# ---------------------------------------------------------------------------


def _lv_matvec(lv: AMGLevel, x):
    """Mid-level operator apply: a dense product on a densified level, K3 on
    a CSR level."""
    if lv.dense_op is not None:
        return lv.dense_op @ x
    return lv.op(x)


def _chebyshev(matvec, dinv, theta, delta, x, b, degree: int):
    """Chebyshev polynomial smoothing of D^-1 A on [theta-delta, theta+delta].
    x=None stands for a zero initial guess (its matvec is skipped: it is 0)."""
    sigma = theta / delta
    rho = 1.0 / sigma
    r = dinv * (b if x is None else b - matvec(x))
    d = r / theta
    for _ in range(degree - 1):
        x = d if x is None else x + d
        r = r - dinv * matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return d if x is None else x + d


def v_cycle(h: AMGPrecond, fine_matvec: Callable, r, layout=None):
    """One V-cycle; level 0 applies `fine_matvec` (the masked fine
    operator), deeper levels their own operators. With `layout` (a
    parallel/mesh.SlabLayout) level 0 is DOF-sharded: r, `fine_matvec` and
    level 0's dinv are ShardedVectors, the residual is gathered for the
    restriction and the prolonged correction is scattered; the levels below
    lie where the hierarchy does."""
    return _v(h, 0, fine_matvec, r, layout)


def _v(h: AMGPrecond, i: int, mv: Callable, r, layout=None):
    lv = h.levels[i]
    down, up = ((lambda v: v,) * 2 if layout is None
                else (layout.gather, layout.scatter))
    if i == len(h.levels) - 1:
        return up(h.coarse_inv @ down(r))
    x = _chebyshev(mv, lv.dinv, lv.theta, lv.delta, None, r, h.degree)
    rc = lv.R(down(r - mv(x)))
    nxt = h.levels[i + 1]
    xc = _v(h, i + 1, lambda v: _lv_matvec(nxt, v), rc)
    x = x + up(lv.P(xc))
    return _chebyshev(mv, lv.dinv, lv.theta, lv.delta, x, r, h.degree)


def preconditioner(h: AMGPrecond, fine_matvec: Callable,
                   layout=None) -> Callable:
    if layout is not None:
        fine = dataclasses.replace(h.levels[0],
                                   dinv=layout.scatter(h.levels[0].dinv))
        h = dataclasses.replace(h, levels=(fine,) + h.levels[1:])
    return lambda r: v_cycle(h, fine_matvec, r, layout)
