"""Legacy ASCII VTK writer, format-compatible with the reference.

Mirrors WriteOutput (m_io.F90:480-555): UNSTRUCTURED_GRID with POINTS
(z=0-padded in 2D, Fortran F0.3 formatting), CELLS (0-based node ids),
CELL_TYPES, then POINT_DATA with `SCALARS STRESS FLOAT <cpdim>` and
`VECTORS displacements double` (F0.6). Fortran F0.d prints no leading zero
(".000", "-.000000") — replicated so outputs diff cleanly against the
checked-in goldens.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # avoid a circular import (models.problem uses io.inp)
    from fem_tpu_torch.models.problem import Problem


def _f0(v: float, decimals: int) -> str:
    s = f"{v:.{decimals}f}"
    if s.startswith("0."):
        s = s[1:]
    elif s.startswith("-0."):
        s = "-" + s[2:]
    return s


def write(
    path: str,
    coords: np.ndarray,
    cells: Sequence[Tuple[int, np.ndarray]],
    stress: np.ndarray,
    displacements: np.ndarray,
) -> None:
    """Write one VTK file.

    Args:
      coords: (nnds, pdim) node coordinates.
      cells: list of (vtk_id, node_ids[0-based]) in output order.
      stress: (nnds, cpdim) nodal stress field.
      displacements: (nnds*pdim,) interleaved displacement vector.
    """
    nnds, pdim = coords.shape
    cpdim = stress.shape[1]
    lines: List[str] = []
    lines.append("# vtk DataFile Version 2.0")
    lines.append("File written by Defmod")  # keep the reference banner
    lines.append("ASCII")
    lines.append("DATASET UNSTRUCTURED_GRID")
    lines.append(f"POINTS {nnds} double")
    for i in range(nnds):
        xyz = list(coords[i]) + [0.0] * (3 - pdim)
        lines.append(" ".join(_f0(v, 3) for v in xyz) + " ")
    total = sum(len(nodes) + 1 for _, nodes in cells)
    lines.append(f"CELLS {len(cells)} {total}")
    for _, nodes in cells:
        lines.append(
            f"{len(nodes)} " + " ".join(str(int(n)) for n in nodes)
        )
    lines.append(f"CELL_TYPES {len(cells)}")
    for vtk_id, _ in cells:
        lines.append(str(vtk_id))
    lines.append(f"POINT_DATA {nnds}")
    lines.append(f"SCALARS STRESS FLOAT {cpdim}")
    lines.append("LOOKUP_TABLE DEFAULT")
    for i in range(nnds):
        lines.append(" ".join(_f0(v, 6) for v in stress[i]) + " ")
    lines.append("VECTORS displacements double")
    u = displacements.reshape(nnds, pdim)
    for i in range(nnds):
        xyz = list(u[i]) + [0.0] * (3 - pdim)
        lines.append(" ".join(_f0(v, 6) for v in xyz) + " ")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cells_in_deck_order(problem: "Problem") -> List[Tuple[int, np.ndarray]]:
    """Rebuild (vtk_id, conn) in original deck element order from the
    type-batched blocks (the reference writes elements in storage order,
    m_io.F90:522-526)."""
    items = []
    for b in problem.blocks.values():
        vtk_id = b.et.vtk_id
        for j in range(b.ne):
            items.append((int(b.eids[j]), vtk_id, b.conn[j]))
    items.sort(key=lambda x: x[0])
    return [(vtk_id, conn) for _, vtk_id, conn in items]


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
