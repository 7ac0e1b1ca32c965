"""Element-sharded matrix-free elastic operator.

Port of `fem_tpu/parallel/ops.py`. Replaces the reference's METIS
partitioning + PETSc distributed assembly (PartitionBroadcast
m_io.F90:107-143, DistributeElements m_io.F90:200-237, MatAssembly /
VecScatter) with element sharding over a parallel/mesh.DeviceMesh:

  - every element-type block is cut along its element axis into one share
    per shard, and share i lives on shard i's device;
  - the displacement vector is replicated (it is small next to the element
    data: ndof ~ nodes * pdim against O(ne * ndof_e^2));
  - K @ u is: replicate u, then on each shard gather -> element force ->
    scatter-add into a full-length vector, summed over the shard's blocks,
    and ONE all-reduce of that vector. The all-reduce is the shared-node
    reduction PETSc performed in MatAssembly (SURVEY.md §2c).

Partition quality does not matter here (unlike METIS): every shard does the
same dense batched work and the reduction is O(ndof) whatever the partition,
so plain block order is taken. Shares may differ by one element (fem_tpu pads
them to equal size with zero elements; the sum is the same).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import operator as op_mod
from fem_tpu_torch.parallel import mesh as mesh_mod


def _shares(a: torch.Tensor, mesh: mesh_mod.DeviceMesh) -> List[torch.Tensor]:
    """a cut along axis 0 into mesh.size contiguous shares, share i on shard
    i's device (a view where that is a's own device)."""
    ne, n = a.shape[0], mesh.size
    return mesh_mod.scatter(mesh, [a[ne * i // n:ne * (i + 1) // n]
                                   for i in range(n)])


class ShardedOperator:
    """Element-sharded elastic operator over a 1D device mesh.

    mode="fused" shards the fused operator's per-element data (dNx and the
    scaled Lame parameters; 3x less element data than stored k_e) and
    applies ops/operator.py's own block force; mode="ke" shards the stored
    element stiffness. matvec and diag take and return vectors on shard 0's
    device, where the caller's CG vector algebra runs, replicated."""

    def __init__(self, system: System,
                 mesh: Optional[mesh_mod.DeviceMesh] = None,
                 mode: str = "fused"):
        if mode not in ("fused", "ke"):
            raise ValueError(f"unknown ShardedOperator mode {mode!r}")
        self.system = system
        self.mesh = mesh or mesh_mod.make_mesh(device=system.device)
        self.mode = mode
        self.ndof = system.ndof
        n = self.mesh.size
        if mode == "ke":
            # per shard: [(ke, edofs)] of each block
            self.shards = [[] for _ in range(n)]
            for e in system._continuum():
                for i, pair in enumerate(zip(_shares(e["ke"], self.mesh),
                                             _shares(e["edofs"], self.mesh))):
                    self.shards[i].append(pair)
        else:
            full = op_mod.build(system)
            cut = [[_shares(getattr(b, f.name), self.mesh)
                    for f in dataclasses.fields(b)] for b in full.blocks]
            self.shards = [
                dataclasses.replace(full, blocks=tuple(
                    op_mod.FusedBlock(*(share[i] for share in block))
                    for block in cut))
                for i in range(n)]

    def _reduce(self, parts):
        return mesh_mod.all_reduce_sum(self.mesh, parts)[0]

    def matvec(self, u):
        """K @ u: one replicate of u, one all-reduce of the result."""
        us = mesh_mod.replicate(self.mesh, u)
        if self.mode == "fused":
            return self._reduce([op_mod.matvec(op, ui)
                                 for op, ui in zip(self.shards, us)])
        parts = []
        for blocks, ui in zip(self.shards, us):
            out = torch.zeros_like(ui)
            for ke, edofs in blocks:
                fe = torch.einsum("eab,eb->ea", ke, ui[edofs])
                out.index_add_(0, edofs.reshape(-1), fe.reshape(-1))
            parts.append(out)
        return self._reduce(parts)

    def diag(self):
        if self.mode == "fused":
            return self._reduce([op_mod.diag(op) for op in self.shards])
        parts = []
        for blocks, dev in zip(self.shards, self.mesh.devices):
            d = torch.zeros(self.ndof, dtype=self.system.dtype, device=dev)
            for ke, edofs in blocks:
                d.index_add_(0, edofs.reshape(-1),
                             torch.diagonal(ke, dim1=1, dim2=2).reshape(-1))
            parts.append(d)
        return self._reduce(parts)


def solve_step_sharded(system: System, op: ShardedOperator, t_init,
                       du0=None, rtol: float = 1e-9, maxiter: int = 0):
    """One elastic load increment with the sharded operator: RHS, eliminated
    BCs, Jacobi-PCG, stress recovery. Returns (du, nodal stress, iters)."""
    from fem_tpu_torch.solver import cg  # the solver package imports this one

    res = cg.solve_eliminated(op.matvec, system.rhs(t_init), op.diag(),
                              system.bc_dofs, system.bc_step_vals(), x0=du0,
                              rtol=rtol, maxiter=maxiter)
    return res.x, system.stress_increment(res.x), res.iters
