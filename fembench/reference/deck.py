"""Plain readers of the reference: the deck text (defmod's `.inp` format, as
its make_example tool writes it) and the legacy ASCII VTK file.

Deck layout: `stype pdim nodal_bw`; the counts `nels nnds nmts nceqs nfrcs
ntrcs nbcs` (7, make_example's) or with `ncohmats` after `nmts` (8); `t dt
...`; one line per element `type n1..nk mat [nlmat]` (1-based nodes); one
line of coordinates per node; one line per material `E nu visc expn rho`;
one line per held node `node flag.. value..` (flag 0: held); one line per
point load `node f.. t1 t2` (windows clipped to t). Only decks of one
element type without cohesive materials, constraint equations or
tractions are read here.
"""

from __future__ import annotations

import numpy as np

NODES = {"qua": 4, "hex": 8, "tri": 3, "tet": 4}
# legacy VTK cell type of each element type
VTK_TYPE = {"tri": 5, "qua": 9, "tet": 10, "hex": 12}


def parse(text):
    """The deck's mesh and loads as plain arrays (0-based nodes)."""
    lines = [ln.split() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln]
    stype, pdim = lines[0][0], int(lines[0][1])
    counts = [int(x) for x in lines[1]]
    if len(counts) == 8:
        nels, nnds, nmts, ncoh, nceqs, nfrcs, ntrcs, nbcs = counts
    else:
        nels, nnds, nmts, nceqs, nfrcs, ntrcs, nbcs = counts
        ncoh = 0
    if ncoh or nceqs or ntrcs:
        raise ValueError("deck has cohesive materials, constraint equations "
                         "or tractions")
    t, dt = float(lines[2][0]), float(lines[2][1])
    at = 3
    els = lines[at:at + nels]
    at += nels
    types = {e[0] for e in els}
    if len(types) != 1:
        raise ValueError(f"deck mixes element types {sorted(types)}")
    etype = types.pop()
    nn = NODES[etype]
    conn = np.array([e[1:1 + nn] for e in els], dtype=np.int64) - 1
    mat = np.array([e[1 + nn] for e in els], dtype=np.int64) - 1
    coords = np.array([c[:pdim] for c in lines[at:at + nnds]], dtype=float)
    at += nnds
    mats = np.array([m[:5] for m in lines[at:at + nmts]], dtype=float)
    at += nmts
    bc = lines[at:at + nbcs]
    at += nbcs
    held = {}
    for rec in bc:  # later records win for a dof
        node = int(rec[0]) - 1
        for d in range(pdim):
            if int(rec[1 + d]) == 0:
                held[node * pdim + d] = float(rec[1 + pdim + d])
    fr = lines[at:at + nfrcs]
    force_node = np.array([int(f[0]) - 1 for f in fr], dtype=np.int64)
    force_vec = np.array([f[1:1 + pdim] for f in fr], dtype=float)
    force_t1 = np.minimum(np.array([float(f[1 + pdim]) for f in fr]), t)
    force_t2 = np.minimum(np.array([float(f[2 + pdim]) for f in fr]), t)
    bc_dofs = np.array(sorted(held), dtype=np.int64)
    return dict(
        stype=stype, pdim=pdim, t=t, dt=dt, etype=etype, coords=coords,
        conn=conn, mat=mat, mats=mats, bc_dofs=bc_dofs,
        bc_vals=np.array([held[d] for d in bc_dofs]),
        force_dofs=force_node[:, None] * pdim + np.arange(pdim),
        force_vec=force_vec.reshape(-1, pdim), force_t1=force_t1,
        force_t2=force_t2,
    )


def read_vtk(path):
    """POINTS (n, 3), cells (ncells, nn) and cell types, and the point data
    STRESS (n, cp) and displacements (n, 3) of a legacy ASCII VTK file."""
    with open(path) as f:
        lines = f.read().splitlines()
    out, i = {}, 0

    def block(start, count):
        return np.array(" ".join(lines[start:start + count]).split(),
                        dtype=float).reshape(count, -1)

    while i < len(lines):
        head = lines[i].split()
        if not head:
            i += 1
            continue
        if head[0] == "POINTS":
            n = int(head[1])
            out["points"] = block(i + 1, n)
            i += 1 + n
        elif head[0] == "CELLS":
            m = int(head[1])
            cells = block(i + 1, m).astype(np.int64)
            out["cells"] = cells[:, 1:]
            i += 1 + m
        elif head[0] == "CELL_TYPES":
            m = int(head[1])
            out["cell_types"] = block(i + 1, m).astype(np.int64).reshape(-1)
            i += 1 + m
        elif head[0] == "SCALARS" and head[1] == "STRESS":
            out["stress"] = block(i + 2, n)  # after LOOKUP_TABLE
            i += 2 + n
        elif head[0] == "VECTORS" and head[1] == "displacements":
            out["displacements"] = block(i + 1, n)
            i += 1 + n
        else:
            i += 1
    return out
