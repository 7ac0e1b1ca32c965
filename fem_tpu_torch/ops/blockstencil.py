"""Variable-coefficient block-stencil operator for lattice-topology meshes.

Port of `fem_tpu.ops.blockstencil` (detect, build, matvec, and the
DOF-sharded halo layout). Operator tiers
of the elastic matvec:

  1. ops/structured.py: geometrically uniform boxes, one constant stencil.
  2. THIS MODULE: meshes whose assembled CONNECTIVITY is a lattice though
     the geometry is not (jittered, graded, mapped grids): per-node-pair
     (pdim, pdim) blocks of the assembled K on the 3^dim lattice offsets,
     applied as shifted windows of the padded solution grid, with no
     gather indices.
  3. ops/operator.py: genuinely unstructured topology, the fused
     gather/scatter matvec.

Detection is exact and topology-only: the lattice strides are inferred from
node 0's neighbour set, then EVERY nonzero block must couple nodes whose
lattice offsets lie in {-1, 0, 1}^dim. Assembly consumes the RAW assembled
matrix, so `matvec` reproduces ops/operator.matvec (same K, different
schedule), BC-column couplings included.

Layout: node-major, as the solvers' flat interleaved vectors are. A flat
(ndof,) vector viewed as (*dims, pdim) is the node grid, and the stored
coefficients are vals[n, p, o * pdim + q] for node n, offset o (base-3 lex,
slowest axis first) and components p, q. One apply stacks the 3^dim shifted
windows into one (nnds, 3^dim * pdim) tensor and contracts it with vals in
one batched product.

Over a device mesh (`shard_rows`, `halo_matvec_g`) each shard holds the rows
of `vals` of a slab of node planes of the leading lattice axis, the vectors
stay in the same slabs, and one K.u moves exactly two node planes: each
shard receives its left neighbour's last plane and its right neighbour's
first. The coefficient slabs are disjoint (the blocks are rooted at rows), so
only planes of u ever move.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class BlockStencilOperator:
    vals: torch.Tensor  # (nnds, pdim, 3^dim * pdim)
    dims: Tuple[int, ...]
    pdim: int

    @property
    def nnds(self) -> int:
        return int(np.prod(self.dims))


def detect(A, pdim: int, nnds: int) -> Optional[Tuple[int, ...]]:
    """Infer lattice dims (NX[, NY[, NZ]]) from the assembled CSR's node
    connectivity, or None if the topology is not a lex-ordered lattice.

    Node ids must enumerate the lattice lexicographically (last axis
    fastest). Strides are inferred from node 0 (a lattice corner), then
    every nonzero block must couple nodes at {-1,0,1}^dim offsets.
    """
    if A.shape[0] != pdim * nnds:
        return None
    # node-0 neighbourhood from its pdim dof rows
    j0 = np.unique(A.indices[: A.indptr[pdim]] // pdim)
    d0 = np.unique(j0[j0 > 0])
    if d0.size == 3:  # 2D corner: {1, NY, NY+1}
        if d0[0] != 1 or d0[2] != d0[1] + 1:
            return None
        NY = int(d0[1])
        if NY <= 1 or nnds % NY:
            return None
        dims = (nnds // NY, NY)
    elif d0.size == 7:  # 3D corner: {1, NZ, NZ+1, NYNZ, +1, +NZ, +NZ+1}
        NZ, NYNZ = int(d0[1]), int(d0[3])
        if (d0[0] != 1 or d0[2] != NZ + 1 or NZ <= 1
                or NYNZ % NZ or nnds % NYNZ):
            return None
        if not np.array_equal(
            d0, np.array([1, NZ, NZ + 1, NYNZ, NYNZ + 1, NYNZ + NZ,
                          NYNZ + NZ + 1])
        ):
            return None
        dims = (nnds // NYNZ, NYNZ // NZ, NZ)
    else:
        return None
    if any(d < 2 for d in dims):
        return None
    if not offsets_ok(A, pdim, dims):
        return None
    return dims


def _axis_offsets(A, pdim: int, dims: Tuple[int, ...]):
    """Per-axis lattice offset (slowest axis first) of every stored entry
    of A (COO order), and the COO form."""
    Ac = A.tocoo()
    rem_i = Ac.row.astype(np.int64) // pdim
    rem_j = Ac.col.astype(np.int64) // pdim
    offs = []
    for d in dims[:0:-1]:  # fastest axis outward
        ci, rem_i = rem_i % d, rem_i // d
        cj, rem_j = rem_j % d, rem_j // d
        offs.append(cj - ci)
    offs.append(rem_j - rem_i)
    return offs[::-1], Ac


def offsets_ok(A, pdim: int, dims: Tuple[int, ...]) -> bool:
    """True iff every stored entry of A couples lattice neighbours (offsets
    in {-1, 0, 1}^dim)."""
    offs, _ = _axis_offsets(A, pdim, dims)
    return all(np.abs(o).max(initial=0) <= 1 for o in offs)


def build(A, pdim: int, dims: Tuple[int, ...], *, dtype=torch.float64,
          device) -> BlockStencilOperator:
    """Scatter the assembled CSR's (pdim, pdim) node blocks onto the
    (nnds, pdim, 3^dim * pdim) offset table (host-side, once)."""
    offs, Ac = _axis_offsets(A, pdim, dims)
    off = np.zeros(Ac.nnz, dtype=np.int64)
    for d in offs:  # slowest axis first => lex offset index
        off = off * 3 + (d + 1)
    nnds = int(np.prod(dims))
    noffs = 3 ** len(dims)
    vals = np.zeros((nnds, pdim, noffs * pdim))
    vals[Ac.row // pdim, Ac.row % pdim, off * pdim + Ac.col % pdim] = Ac.data
    return BlockStencilOperator(
        vals=timing.upload(vals, dtype=dtype, device=device),
        dims=tuple(int(d) for d in dims), pdim=int(pdim))


def _apply_padded(vals, up, dims: Tuple[int, ...]):
    """vals (nnds, pdim, 3^dim * pdim) applied to the node grid `dims` given
    with one more plane on every side, up (*(dims + 2), pdim); returns
    (*dims, pdim)."""
    windows = torch.stack([
        up[tuple(slice(o, o + d) for o, d in zip(offs, dims))]
        for offs in np.ndindex(*(3,) * len(dims))
    ], dim=-2)  # (*dims, 3^dim, pdim)
    out = torch.bmm(vals, windows.view(vals.shape[0], vals.shape[2], 1))
    return out.view(*dims, vals.shape[1])


def matvec(op: BlockStencilOperator, u):
    """A @ u for a flat interleaved (ndof,) vector (the node-major grid)."""
    up = F.pad(u.view(*op.dims, op.pdim), [0, 0] + [1, 1] * len(op.dims))
    return _apply_padded(op.vals, up, op.dims).view(-1)


# ---------------------------------------------------------------------------
# DOF-sharded slab layout (halo exchange)
# ---------------------------------------------------------------------------


def vals_to_slabs(op: BlockStencilOperator, nd: int) -> List[torch.Tensor]:
    """vals -> nd disjoint row slabs (c_i * plane, pdim, 3^dim * pdim), the
    rows of node planes [start_i, end_i) of the leading axis
    (mesh.slab_bounds: equal where nd divides it, else the first slabs one
    plane longer; empty last slabs where there are more shards than
    planes)."""
    plane = int(np.prod(op.dims[1:]))
    return [op.vals[s * plane:e * plane]
            for s, e in mesh_mod.slab_bounds(op.dims[0], nd)]


def u_to_slabs(u_g, nd: int) -> List[torch.Tensor]:
    """(nx, *rest, pdim) -> nd slabs (c_i, *rest, pdim), cut as vals."""
    return [u_g[s:e] for s, e in mesh_mod.slab_bounds(u_g.shape[0], nd)]


def u_from_slabs(slabs) -> torch.Tensor:
    """Inverse of u_to_slabs, for slabs on one device."""
    return torch.cat(list(slabs))


@dataclasses.dataclass(frozen=True)
class HaloBlockStencil:
    """A BlockStencilOperator's rows dealt out over a mesh: vals[i] on shard
    i's device."""

    mesh: mesh_mod.DeviceMesh
    vals: Tuple[torch.Tensor, ...]
    dims: Tuple[int, ...]
    pdim: int

    def layout(self) -> mesh_mod.SlabLayout:
        """Flat (ndof,) vectors on shard 0 to and from this operator's
        slabs."""
        gshape, nd = self.dims + (self.pdim,), self.mesh.size
        return mesh_mod.SlabLayout(
            self.mesh, lambda v: u_to_slabs(v.view(gshape), nd),
            lambda slabs: u_from_slabs(slabs).view(-1))


def shard_rows(op: BlockStencilOperator,
               mesh: mesh_mod.DeviceMesh) -> HaloBlockStencil:
    """Deal op's row slabs out, slab i onto shard i's device."""
    return HaloBlockStencil(
        mesh, tuple(mesh_mod.scatter(mesh, vals_to_slabs(op, mesh.size))),
        op.dims, op.pdim)


def halo_matvec_g(hop: HaloBlockStencil, u_slabs) -> List[torch.Tensor]:
    """K @ u on the slab layout, slab i (c_i, *rest, pdim) on shard i's
    device: two one-plane exchanges, then the stacked-window product of
    `matvec` on each slab extended by the two planes received. A shard with
    no neighbour on a side, or an empty one, gets a zero plane there: its
    rows have no block on that side."""
    from_left = mesh_mod.neighbor_exchange(
        hop.mesh, [u[-1:] for u in u_slabs], 1)
    from_right = mesh_mod.neighbor_exchange(
        hop.mesh, [u[:1] for u in u_slabs], -1)
    pad = [0, 0] + [1, 1] * (len(hop.dims) - 1)
    out = []
    for vals, u, lo, hi in zip(hop.vals, u_slabs, from_left, from_right):
        zero = u.new_zeros((1,) + u.shape[1:])
        ext = torch.cat([zero if lo is None or not len(lo) else lo, u,
                         zero if hi is None or not len(hi) else hi])
        out.append(_apply_padded(vals, F.pad(ext, pad), tuple(u.shape[:-1])))
    return out
