"""DOF-sharded halo K.u for general unstructured meshes.

Port of `fem_tpu/parallel/halo_gather.py`. The element-sharded
ShardedOperator (parallel/ops.py) all-reduces a full O(ndof) vector per K.u;
the block-stencil halo (ops/blockstencil.halo_matvec_g) avoids that for
lattice decks; this module does for any single-element-type mesh in any node
numbering (the reference's distributed Mat and VecScatter ghost exchange,
m_global.F90:549-564 / main.F90:184-191, over a 1D device mesh):

  1. Nodes are renumbered by a coordinate-lexicographic sort (a cheap
     bandwidth reducer, the role of the reference's METIS partition,
     m_io.F90:107-143). Shard d owns the contiguous slab of S nodes
     [d S, (d + 1) S) of that order; the last slab is filled up to S with
     phantom nodes that no element touches.
  2. Each element goes to the slab of its median node; the halo width B is
     the farthest any element reaches past its slab. With spatial locality
     B ~ nnds^(2/3) << S.
  3. Each shard holds its elements' data of the fused operator
     (ops/operator.FusedBlock) with connectivity local to its extended slab
     of S + 2 B nodes: [0, B) the left band, [B, B + S) its own nodes,
     [B + S, S + 2 B) the right band.
  4. One K.u exchanges four (B, pdim) bands: each shard fetches its
     neighbours' boundary values, applies ops/operator.block_force to its
     elements, scatter-adds with index_add_, and returns what fell into the
     bands to their owners. The traffic per shard is 4 B pdim values, not
     ndof.

`build` raises ValueError when the mesh has several element blocks or when
an element reaches farther than a slab; the caller then keeps the
element-sharded operator.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops import operator as op_mod
from fem_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class HaloGatherOp:
    """blocks[d]: shard d's elements on its device, `conn` in local ids of
    its extended slab."""

    mesh: mesh_mod.DeviceMesh
    blocks: Tuple[op_mod.FusedBlock, ...]
    S: int
    B: int
    nnds: int
    pdim: int

    def layout(self) -> mesh_mod.SlabLayout:
        """Flat (ndof,) vectors in slab order on shard 0 to and from the
        (S, pdim) slabs (the last one zero-filled past the real nodes)."""
        nd, S, pdim, n = self.mesh.size, self.S, self.pdim, self.nnds

        def split(v):
            vp = torch.cat([v.view(n, pdim),
                            v.new_zeros((nd * S - n, pdim))])
            return list(vp.view(nd, S, pdim))

        return mesh_mod.SlabLayout(
            self.mesh, split, lambda slabs: torch.cat(slabs)[:n].reshape(-1))


def slab_order(coords) -> np.ndarray:
    """pos[node]: the node's place in the coordinate-lexicographic order
    (x first, then y, then z)."""
    coords = np.asarray(coords, dtype=np.float64)
    order = np.lexsort(tuple(coords[:, k]
                             for k in range(coords.shape[1] - 1, -1, -1)))
    pos = np.empty(coords.shape[0], dtype=np.int64)
    pos[order] = np.arange(coords.shape[0])
    return pos


def build(system, mesh: mesh_mod.DeviceMesh):
    """Set-up on the host. Returns (HaloGatherOp, pos), pos[node] the node's
    place in the slab order. Raises ValueError when the layout does not
    apply (several element blocks, or an element reach beyond a slab)."""
    fop = op_mod.build(system)
    vol = [b for b in fop.blocks if b.conn.shape[0] > 0]
    if len(vol) != 1:
        raise ValueError(
            f"halo_gather supports single-element-type meshes "
            f"(got {len(vol)} blocks)")
    b = vol[0]
    nd, pdim = mesh.size, system.pdim
    pos = slab_order(system.problem.coords)
    nnds = pos.shape[0]
    pconn = pos[b.conn.cpu().numpy()]  # (ne, nn) slab-order node ids
    nn = pconn.shape[1]
    S = -(-nnds // nd)
    med = np.sort(pconn, axis=1)[:, nn // 2]  # each element's median node
    dev = np.clip(med // S, 0, nd - 1)
    reach_l = np.maximum(dev * S - pconn.min(axis=1), 0)
    reach_r = np.maximum(pconn.max(axis=1) - ((dev + 1) * S - 1), 0)
    B = int(max(reach_l.max(initial=0), reach_r.max(initial=0), 1))
    if B > S:
        raise ValueError(
            f"element reach B={B} exceeds slab size S={S}; mesh has no "
            f"spatial locality under the slab order — use the psum path")
    per_dev = [np.nonzero(dev == d)[0] for d in range(nd)]
    root = b.conn.device
    shares = []
    for d, ix in enumerate(per_dev):
        sel = torch.as_tensor(ix, device=root)
        shares.append((
            torch.as_tensor(pconn[ix] - (d * S - B), device=root),
            b.dNx[sel], b.lam_s[sel], b.mu_s[sel]))
    dealt = [mesh_mod.scatter(mesh, list(field)) for field in zip(*shares)]
    blocks = tuple(op_mod.FusedBlock(*fields) for fields in zip(*dealt))
    return HaloGatherOp(mesh, blocks, S, B, nnds, pdim), pos


def dof_order(pos, pdim: int) -> np.ndarray:
    """idx with v_slab = v[idx]: the deck's interleaved DOFs in slab order."""
    return (np.argsort(pos)[:, None] * pdim + np.arange(pdim)).reshape(-1)


def matvec(op: HaloGatherOp, u_slabs) -> List[torch.Tensor]:
    """K @ u on slab-ordered state, slab d (S, pdim) on shard d's device:
    four (B, pdim) band exchanges (fetch the neighbours' boundary values,
    return the neighbours' contributions), no O(ndof) collective. An end
    shard's outer band is never referenced: no element reaches there."""
    S, B, mesh = op.S, op.B, op.mesh
    lb = mesh_mod.neighbor_exchange(mesh, [u[S - B:] for u in u_slabs], 1)
    rb = mesh_mod.neighbor_exchange(mesh, [u[:B] for u in u_slabs], -1)
    ext = []
    for blk, u, lo, hi in zip(op.blocks, u_slabs, lb, rb):
        zero = torch.zeros_like(u[:B])
        u_ext = torch.cat([zero if lo is None else lo, u,
                           zero if hi is None else hi])  # (S + 2B, pdim)
        f = op_mod.block_force(blk, op.pdim, u_ext[blk.conn])
        ext.append(torch.zeros_like(u_ext).index_add_(
            0, blk.conn.reshape(-1), f.reshape(-1, op.pdim)))
    from_right = mesh_mod.neighbor_exchange(mesh, [o[:B] for o in ext], -1)
    from_left = mesh_mod.neighbor_exchange(mesh, [o[S + B:] for o in ext], 1)
    out = []
    for o, fr, fl in zip(ext, from_right, from_left):
        own = o[B:B + S]
        if fr is not None:
            own[S - B:] += fr
        if fl is not None:
            own[:B] += fl
        out.append(own)
    return out
