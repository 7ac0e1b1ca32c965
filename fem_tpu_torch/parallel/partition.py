"""Element partitioning + local renumbering: per-shard mesh views.

Port of `fem_tpu/parallel/partition.py`; host numpy only. Replicates the
reference's distribution machinery (METIS epart, m_io.F90:137; per-rank
element ownership, DistributeElements, m_io.F90:200-237; global->local node
renumbering and the nl2g map, main.F90:49-97) so that results can be written
as one legacy VTK file per shard exactly like the reference's per-rank
writers (m_io.F90:480-555).

The solve needs none of this (parallel/ops.py shards elements in block order
and sums shared dofs with one all-reduce); this module exists for I/O parity.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from fem_tpu_torch.io import native, vtk
from fem_tpu_torch.models.problem import Problem


@dataclasses.dataclass
class ShardMesh:
    """One shard's local view: local connectivity + nl2g node map."""

    rank: int
    nl2g: np.ndarray  # (local_nnds,) local -> global node ids
    coords: np.ndarray  # (local_nnds, pdim)
    cells: List  # [(vtk_id, local_conn)] in global element order


def element_centroids(problem: Problem) -> np.ndarray:
    """(nels, pdim) centroid per element, in deck element order."""
    out = np.zeros((problem.nels, problem.pdim))
    for b in problem.blocks.values():
        out[b.eids] = problem.coords[b.conn].mean(axis=1)
    return out


def partition(problem: Problem, nparts: int,
              method: str = "rcb") -> np.ndarray:
    """(nels,) shard id per element (deck order): "rcb", recursive coordinate
    bisection of the centroids by the native engine (native.rcb_partition
    takes its numpy form when the library is not built), or "block",
    contiguous runs of deck order."""
    if nparts <= 1:
        return np.zeros(problem.nels, dtype=np.int32)
    if method == "block":
        return (np.arange(problem.nels) * nparts
                // problem.nels).astype(np.int32)
    if method != "rcb":
        raise ValueError(f"unknown partition method {method!r}")
    return native.rcb_partition(element_centroids(problem), nparts)


def shard_meshes(problem: Problem, epart: np.ndarray) -> List[ShardMesh]:
    """Build each shard's local mesh exactly like the reference: collect the
    shard's elements, mark referenced nodes, renumber ascending-global
    (main.F90:61-84), map connectivity to local ids."""
    nparts = int(epart.max()) + 1 if epart.size else 1
    # deck-order (vtk_id, global_conn) list
    order: List = [None] * problem.nels
    for b in problem.blocks.values():
        for j in range(b.ne):
            order[int(b.eids[j])] = (b.et.vtk_id, b.conn[j])
    shards = []
    for rank in range(nparts):
        eids = np.nonzero(epart == rank)[0]
        used = np.zeros(problem.nnds, dtype=bool)
        for e in eids:
            used[order[e][1]] = True
        nl2g = np.nonzero(used)[0].astype(np.int32)
        g2l = np.full(problem.nnds, -1, dtype=np.int32)
        g2l[nl2g] = np.arange(nl2g.shape[0], dtype=np.int32)
        cells = [(order[e][0], g2l[order[e][1]]) for e in eids]
        shards.append(ShardMesh(rank=rank, nl2g=nl2g,
                                coords=problem.coords[nl2g], cells=cells))
    return shards


def write_sharded_vtk(problem: Problem, aggregate_stress: np.ndarray,
                      aggregate_u: np.ndarray, nparts: int, prefix: str = "",
                      step: int = 0, method: str = "rcb") -> List[str]:
    """Write one `<rank>_output_<step:06d>.vtk` per shard (m_io.F90:496)."""
    epart = partition(problem, nparts, method)
    paths = []
    u = aggregate_u.reshape(problem.nnds, problem.pdim)
    for sm in shard_meshes(problem, epart):
        path = f"{prefix}{sm.rank}_output_{step:06d}.vtk"
        vtk.write(path, sm.coords, sm.cells, aggregate_stress[sm.nl2g],
                  u[sm.nl2g].reshape(-1))
        paths.append(path)
    return paths
