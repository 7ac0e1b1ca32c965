"""The benchmark's input generators, frozen here so that a change to the
program cannot change what is measured.

`hex_box` is a copy of `fem_tpu_torch.io.meshgen.hex_box_problem` (without
its jitter), returning plain arrays in place of a `Problem`; `strip_deck` and
`strip_forces` together are `meshgen.quad_strip_deck`, the reference's
`make_example.F90:33-140`, with the two end forces as an argument. A test
holds both against the program's generators at a small size.

`draw_forces` is the per-deck load of a traffic mix, from the mix's `load`
entry: {"scale": [lo, hi], "direction": "sphere" | "base",
"per": "deck" | "record"}. Each load record keeps its size of the base load
times a scale drawn from U[lo, hi]; "sphere" turns it to a direction drawn
uniformly on the unit sphere (circle in 2D), "base" keeps its direction;
"deck" draws once for all records of a deck, "record" once per record.
"""

from __future__ import annotations

import numpy as np


def hex_box(nx, ny, nz, lx=10.0, ly=1.0, lz=1.0, E=200e9, nu=0.3, t=1.0,
            dt=1.0, tip_load=-1e6):
    """nx x ny x nz hex8 cantilever: x = 0 clamped, a z-directed point load
    of tip_load shared by the nodes of the x = lx face. Plain arrays with
    the fields of the program's Problem; `blocks` maps 'hex' to its conn,
    mat, nlmat and eids."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                      axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    conn = np.stack([nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
                     nid(i, j + 1, k), nid(i, j, k + 1),
                     nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1),
                     nid(i, j + 1, k + 1)], axis=1).astype(np.int32)
    ne = conn.shape[0]
    clamped = np.nonzero(coords[:, 0] == 0.0)[0]
    bc_dofs = (clamped[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
    tip = np.nonzero(coords[:, 0] == lx)[0]
    force_dofs = (tip[:, None] * 3 + np.arange(3)[None, :]).astype(np.int32)
    force_vec = np.zeros((tip.shape[0], 3))
    force_vec[:, 2] = tip_load / tip.shape[0]
    return dict(
        stype="implicit", pdim=3, t=t, dt=dt, coords=coords,
        blocks={"hex": dict(conn=conn, mat=np.zeros(ne, np.int32),
                            nlmat=np.full(ne, -1, np.int32),
                            eids=np.arange(ne, dtype=np.int32))},
        mats=np.array([[E, nu, 0.0, 1.0, 0.0]]),
        coh_laws=np.zeros(0, np.int32), coh_props=np.zeros((0, 6)),
        bc_dofs=bc_dofs.astype(np.int32),
        bc_vals=np.zeros(bc_dofs.shape[0]),
        force_dofs=force_dofs, force_vec=force_vec,
        force_t1=np.zeros(tip.shape[0]), force_t2=np.full(tip.shape[0], t),
        trac_dofs=np.zeros((0, 4, 3), np.int32),
        trac_nodal_vec=np.zeros((0, 3)), trac_t1=np.zeros(0),
        trac_t2=np.zeros(0))


STRIP_FORCES = ((-1e11, 0.0), (-1e11, 0.0))


def strip_deck(x_nels=10, y_nels=1):
    """The text of `make_example <x_nels> <y_nels>` up to its force
    records: unit quads, E = 3e10, nu = 0.25, the corner nodes 1 and
    (top-left) held, t = dt = 0.01."""
    x_nnds, y_nnds = x_nels + 1, y_nels + 1
    nels, nnds = x_nels * y_nels, x_nnds * y_nnds
    lines = [f"implicit 2 {nels}", f"{nels} {nnds} 1 0 2 0 2",
             "0.010000 0.010000 1 1", ""]
    for i in range(y_nels):
        for j in range(x_nels):
            n1 = j + 1 + i * x_nnds
            lines.append(f"qua {n1} {n1 + 1} {n1 + 1 + x_nnds} {n1 + x_nnds} 1")
    lines.append("")
    for i in range(y_nnds):
        for j in range(x_nnds):
            lines.append(f"{float(j):.6f} {float(i):.6f}")
    lines += ["", "30000000000.000000 0.250000 "
              "1000000000000000000.000000 1.000000 3000.000000", ""]
    lines.append("1 0 0 0.000000 0.000000")
    lines.append(f"{1 + (y_nnds - 1) * x_nnds} 0 0 0.000000 0.000000")
    lines.append("")
    return "\n".join(lines) + "\n"


def strip_forces(x_nels, y_nels, forces=STRIP_FORCES):
    """The force records of the strip: forces[0] on the bottom-right corner
    node and forces[1] on the top-right one, over the window [0, 0.01]."""
    x_nnds = x_nels + 1
    nodes = (x_nnds, x_nnds * (y_nels + 1))
    return "\n".join(f"{n} {fx:.6f} {fy:.6f} 0.000000 0.010000"
                     for n, (fx, fy) in zip(nodes, forces)) + "\n"


def draw_forces(rng, base, spec):
    """A deck's force records (nrec, pdim) from the base ones and the mix's
    `load` entry (see the module's docstring)."""
    nrec, pdim = base.shape
    size = np.linalg.norm(base, axis=1, keepdims=True)
    draws = 1 if spec.get("per", "deck") == "deck" else nrec
    lo, hi = spec["scale"]
    scale = np.broadcast_to(rng.uniform(lo, hi, size=(draws, 1)), (nrec, 1))
    if spec.get("direction", "base") == "sphere":
        d = rng.standard_normal((draws, pdim))
        d = np.broadcast_to(d / np.linalg.norm(d, axis=1, keepdims=True),
                            (nrec, pdim))
    else:
        d = base / np.where(size > 0, size, 1.0)
    return scale * d * size
