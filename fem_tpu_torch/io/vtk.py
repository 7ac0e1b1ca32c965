"""Legacy ASCII VTK writer, format-compatible with the reference.

Mirrors WriteOutput (m_io.F90:480-555): UNSTRUCTURED_GRID with POINTS
(z=0-padded in 2D, Fortran F0.3 formatting), CELLS (0-based node ids),
CELL_TYPES, then POINT_DATA with `SCALARS STRESS FLOAT <cpdim>` and
`VECTORS displacements double` (F0.6). Fortran F0.d prints no leading zero
(".000", "-.000000") — replicated so outputs diff cleanly against the
checked-in goldens.

The text is formatted from whole arrays by the host library's
`fem_vtk_text` (`csrc/vtk_text.cpp`, built by `kernels_build`), its rows
split over the CPUs this process may run on, and written with one write.
"""

from __future__ import annotations

import contextlib
import ctypes
from collections.abc import Sequence
from typing import TYPE_CHECKING, Iterator, Tuple

import numpy as np

from fem_tpu_torch import kernels_build

if TYPE_CHECKING:  # avoid a circular import (models.problem uses io.inp)
    from fem_tpu_torch.models.problem import Problem

# Rows (of all five sections together) below which one more thread costs
# more to start than it saves.
ROWS_PER_THREAD = 16384

# The last write's route ("table": a CellTable; "list": (vtk_id, nodes)
# pairs packed into one), the bytes written and the threads that formatted
# them. `write` runs outside `stepper.run`, where `timing` keeps no counts.
last_write: dict = {}


class CellTable(Sequence):
    """Cells as whole arrays: cell i is type `vtk_ids[i]` on nodes
    `nodes[offsets[i]:offsets[i + 1]]`. A sequence of (vtk_id, nodes) pairs,
    as a list of them would be."""

    def __init__(self, vtk_ids: np.ndarray, nodes: np.ndarray,
                 offsets: np.ndarray):
        if (offsets.shape != (vtk_ids.shape[0] + 1,) or offsets[0] != 0
                or offsets[-1] != nodes.shape[0]
                or np.any(np.diff(offsets) < 0)):
            raise ValueError("CellTable: offsets do not cut nodes into cells")
        self.vtk_ids, self.nodes, self.offsets = vtk_ids, nodes, offsets

    @classmethod
    def pack(cls, cells) -> "CellTable":
        """The table of a sequence of (vtk_id, nodes) pairs."""
        cells = list(cells)
        vtk_ids = np.array([int(v) for v, _ in cells], dtype=np.int64)
        rows = [np.asarray(n).reshape(-1) for _, n in cells]
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([r.shape[0] for r in rows], out=offsets[1:])
        nodes = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        return cls(vtk_ids, nodes, offsets)

    def __len__(self) -> int:
        return self.vtk_ids.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self))[i]]
        j = range(len(self))[i]
        return (int(self.vtk_ids[j]),
                self.nodes[self.offsets[j]:self.offsets[j + 1]])

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        bounds = self.offsets.tolist()
        for j, vtk_id in enumerate(self.vtk_ids.tolist()):
            yield vtk_id, self.nodes[bounds[j]:bounds[j + 1]]


@contextlib.contextmanager
def _text(coords: np.ndarray, table: CellTable, stress: np.ndarray,
          displacements: np.ndarray, threads: int):
    """The file's text, formatted by `threads` threads, as a buffer that
    lives until the block ends (the arguments as `write` takes them)."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    nnds, pdim = coords.shape
    stress = np.ascontiguousarray(stress, dtype=np.float64)
    if stress.ndim != 2 or stress.shape[0] != nnds:
        raise ValueError(f"stress {stress.shape} is not ({nnds}, cpdim)")
    disp = np.ascontiguousarray(displacements, dtype=np.float64).reshape(
        nnds, pdim)
    vtk_ids = np.ascontiguousarray(table.vtk_ids, dtype=np.int64)
    offsets = np.ascontiguousarray(table.offsets, dtype=np.int64)
    nodes = np.ascontiguousarray(table.nodes, dtype=np.int64)
    lib = kernels_build.host_library()
    out, n = ctypes.c_void_p(), ctypes.c_longlong()
    if lib.fem_vtk_text(coords.ctypes.data, stress.ctypes.data,
                        disp.ctypes.data, nnds, pdim, stress.shape[1],
                        vtk_ids.ctypes.data, offsets.ctypes.data,
                        nodes.ctypes.data, len(table), threads,
                        ctypes.byref(out), ctypes.byref(n)):
        raise MemoryError("fem_vtk_text: out of memory")
    try:
        yield (ctypes.c_char * n.value).from_address(out.value)
    finally:
        lib.fem_vtk_free(out)


def write(
    path: str,
    coords: np.ndarray,
    cells: Sequence,
    stress: np.ndarray,
    displacements: np.ndarray,
) -> None:
    """Write one VTK file.

    Args:
      coords: (nnds, pdim) node coordinates.
      cells: a CellTable, or a sequence of (vtk_id, node_ids[0-based]) in
        output order.
      stress: (nnds, cpdim) nodal stress field.
      displacements: (nnds*pdim,) interleaved displacement vector.
    """
    route = "table" if isinstance(cells, CellTable) else "list"
    table = cells if route == "table" else CellTable.pack(cells)
    rows = 3 * len(coords) + 2 * len(table)
    threads = kernels_build.host_threads(rows, ROWS_PER_THREAD)
    with _text(coords, table, stress, displacements, threads) as text:
        with open(path, "wb") as f:
            f.write(text)
        size = len(text)
    last_write.update(route=route, bytes=size, threads=threads)


def cells_in_deck_order(problem: "Problem") -> CellTable:
    """Rebuild the cells in original deck element order from the
    type-batched blocks (the reference writes elements in storage order,
    m_io.F90:522-526): a stable argsort of the blocks' eids."""
    blocks = list(problem.blocks.values())
    if not blocks:
        return CellTable(np.zeros(0, np.int64), np.zeros(0, np.int32),
                         np.zeros(1, np.int64))
    order = np.argsort(np.concatenate([b.eids for b in blocks]),
                       kind="stable")
    per = np.concatenate([np.full(b.ne, b.conn.shape[1], np.int64)
                          for b in blocks])
    vtk_ids = np.concatenate([np.full(b.ne, b.et.vtk_id, np.int64)
                              for b in blocks])[order]
    flat = np.concatenate([b.conn.reshape(-1) for b in blocks])
    starts = np.cumsum(per) - per  # each cell's first node in `flat`
    count = per[order]
    offsets = np.zeros(order.shape[0] + 1, dtype=np.int64)
    np.cumsum(count, out=offsets[1:])
    gather = (np.repeat(starts[order] - offsets[:-1], count)
              + np.arange(offsets[-1]))
    return CellTable(vtk_ids, flat[gather], offsets)


def read_fields(path: str):
    """Parse a legacy VTK written by this module or the reference: returns
    (points (n,3), stress (n,cpdim), displacements (n,3)). Used by the golden
    tests to compare against the reference's SNES_test goldens."""
    points, stress, disp = [], [], []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    n = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("POINTS"):
            n = int(ln.split()[1])
            for j in range(n):
                points.append([float(x) for x in lines[i + 1 + j].split()])
            i += n
        elif ln.startswith("SCALARS STRESS"):
            i += 1  # LOOKUP_TABLE
            for j in range(n):
                stress.append([float(x) for x in lines[i + 1 + j].split()])
            i += n
        elif ln.startswith("VECTORS displacements"):
            for j in range(n):
                disp.append([float(x) for x in lines[i + 1 + j].split()])
            i += n
        i += 1
    return np.array(points), np.array(stress), np.array(disp)
