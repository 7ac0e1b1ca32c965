"""Structured mesh generators.

Numpy copy of the builders of `fem_tpu.io.meshgen` that the port's tests and
its smoke run use. `quad_strip_deck` ports the reference's make_example.F90
tool (an N x M structured quad strip with 2 pinned corner nodes and 2 end
forces, written in the legacy 7-count deck format, make_example.F90:33-140).
The builders below it construct `Problem` objects directly in numpy — no text
round-trip — for large-scale tests and runs (e.g. the hex8 cantilever box);
`permute_nodes` scrambles a Problem's node numbering.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from fem_tpu_torch.models.problem import Block, Problem


def quad_strip_deck(x_nels: int = 10, y_nels: int = 1) -> str:
    """Deck text equivalent to `make_example <x_nels> <y_nels>`
    (make_example.F90:33-140): unit quads, E=3e10 nu=0.25 material, corners
    (1, top-left) pinned, -1e11 x-forces on the right corners, t=dt=0.01."""
    x_nnds, y_nnds = x_nels + 1, y_nels + 1
    nels, nnds = x_nels * y_nels, x_nnds * y_nnds
    lines = [
        f"implicit 2 {nels}",
        f"{nels} {nnds} 1 0 2 0 2",
        "0.010000 0.010000 1 1",
        "",
    ]
    for i in range(y_nels):
        for j in range(x_nels):
            n1 = j + 1 + i * x_nnds
            lines.append(
                f"qua {n1} {n1 + 1} {n1 + 1 + x_nnds} {n1 + x_nnds} 1"
            )
    lines.append("")
    for i in range(y_nnds):
        for j in range(x_nnds):
            lines.append(f"{float(j):.6f} {float(i):.6f}")
    lines.append("")
    lines.append("30000000000.000000 0.250000 " +
                 "1000000000000000000.000000 1.000000 3000.000000")
    lines.append("")
    bc1 = 1
    bc2 = 1 + (y_nnds - 1) * x_nnds
    lines.append(f"{bc1} 0 0 0.000000 0.000000")
    lines.append(f"{bc2} 0 0 0.000000 0.000000")
    lines.append("")
    f1, f2 = x_nnds, x_nnds * y_nnds
    lines.append(f"{f1} -100000000000.000000 0.000000 0.000000 0.010000")
    lines.append(f"{f2} -100000000000.000000 0.000000 0.000000 0.010000")
    return "\n".join(lines) + "\n"


def _grid_nodes_2d(nx: int, ny: int, lx: float, ly: float) -> np.ndarray:
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)


def quad_grid_problem(
    nx: int,
    ny: int,
    lx: float = 1.0,
    ly: float = 1.0,
    E: float = 3.0e10,
    nu: float = 0.25,
    t: float = 1.0,
    dt: float = 1.0,
    fix_left: bool = True,
    tip_force: Optional[Tuple[float, float]] = None,
) -> Problem:
    """nx x ny quad4 grid; left edge clamped, optional point force at the
    top-right corner. Built directly as a Problem (no deck text)."""
    coords = _grid_nodes_2d(nx, ny, lx, ly)
    nnx = nx + 1
    i, j = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n1 = (j + i * nnx).reshape(-1)
    conn = np.stack([n1, n1 + 1, n1 + 1 + nnx, n1 + nnx], axis=1).astype(np.int32)
    ne = conn.shape[0]
    blocks = {
        "qua": Block(
            eltype="qua",
            conn=conn,
            mat=np.zeros(ne, dtype=np.int32),
            nlmat=np.full(ne, -1, dtype=np.int32),
            eids=np.arange(ne, dtype=np.int32),
        )
    }
    bc_dofs = []
    bc_vals = []
    if fix_left:
        left = np.nonzero(coords[:, 0] == 0.0)[0]
        for n in left:
            bc_dofs += [2 * n, 2 * n + 1]
            bc_vals += [0.0, 0.0]
    if tip_force is not None:
        tip = int(np.argmax(coords[:, 0] + coords[:, 1] * 1e-9))
        force_dofs = np.array([[2 * tip, 2 * tip + 1]], dtype=np.int32)
        force_vec = np.array([list(tip_force)])
        force_t1 = np.array([0.0])
        force_t2 = np.array([t])
    else:
        force_dofs = np.zeros((0, 2), dtype=np.int32)
        force_vec = np.zeros((0, 2))
        force_t1 = force_t2 = np.zeros(0)
    return Problem(
        stype="implicit",
        pdim=2,
        t=t,
        dt=dt,
        coords=coords,
        blocks=blocks,
        mats=np.array([[E, nu, 0.0, 1.0, 0.0]]),
        coh_laws=np.zeros(0, dtype=np.int32),
        coh_props=np.zeros((0, 6)),
        bc_dofs=np.array(bc_dofs, dtype=np.int32),
        bc_vals=np.array(bc_vals),
        force_dofs=force_dofs,
        force_vec=force_vec,
        force_t1=force_t1,
        force_t2=force_t2,
        trac_dofs=np.zeros((0, 2, 2), dtype=np.int32),
        trac_nodal_vec=np.zeros((0, 2)),
        trac_t1=np.zeros(0),
        trac_t2=np.zeros(0),
    )


def hex_box_problem(
    nx: int,
    ny: int,
    nz: int,
    lx: float = 10.0,
    ly: float = 1.0,
    lz: float = 1.0,
    E: float = 200e9,
    nu: float = 0.3,
    t: float = 1.0,
    dt: float = 1.0,
    tip_load: float = -1e6,
    jitter: float = 0.0,
    seed: int = 0,
) -> Problem:
    """3D hex8 cantilever: clamped at x=0, z-directed point loads on the free
    x=lx face. At 80^3 cells and unit lengths this is the 1,594,323-DOF
    structured solve of the scale path.

    jitter > 0 perturbs every INTERIOR node by jitter*h*U(-1/2, 1/2) per
    axis (boundary nodes stay put so the BC/load selections hold). This
    produces a genuinely unstructured mesh — `ops/structured.detect` rejects
    it (the reference's MUMPS handles any mesh, main.F90:354-390)."""
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], axis=1)
    if jitter:
        rng = np.random.default_rng(seed)
        h = np.array([lx / nx, ly / ny, lz / nz])
        interior = (
            (coords[:, 0] > 0.0) & (coords[:, 0] < lx)
            & (coords[:, 1] > 0.0) & (coords[:, 1] < ly)
            & (coords[:, 2] > 0.0) & (coords[:, 2] < lz)
        )
        pert = jitter * h * (rng.random((coords.shape[0], 3)) - 0.5)
        coords = coords + np.where(interior[:, None], pert, 0.0)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    # hex8 node ordering matching the registry's sign pattern:
    # bottom face (z-) CCW then top face (z+).
    conn = np.stack(
        [
            nid(i, j, k),
            nid(i + 1, j, k),
            nid(i + 1, j + 1, k),
            nid(i, j + 1, k),
            nid(i, j, k + 1),
            nid(i + 1, j, k + 1),
            nid(i + 1, j + 1, k + 1),
            nid(i, j + 1, k + 1),
        ],
        axis=1,
    ).astype(np.int32)
    ne = conn.shape[0]
    blocks = {
        "hex": Block(
            eltype="hex",
            conn=conn,
            mat=np.zeros(ne, dtype=np.int32),
            nlmat=np.full(ne, -1, dtype=np.int32),
            eids=np.arange(ne, dtype=np.int32),
        )
    }
    clamped = np.nonzero(coords[:, 0] == 0.0)[0]
    bc_dofs = (clamped[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
    bc_vals = np.zeros_like(bc_dofs, dtype=float)
    tip_nodes = np.nonzero(coords[:, 0] == lx)[0]
    force_dofs = (tip_nodes[:, None] * 3 + np.arange(3)[None, :]).astype(np.int32)
    force_vec = np.zeros((tip_nodes.shape[0], 3))
    force_vec[:, 2] = tip_load / tip_nodes.shape[0]
    return Problem(
        stype="implicit",
        pdim=3,
        t=t,
        dt=dt,
        coords=coords,
        blocks=blocks,
        mats=np.array([[E, nu, 0.0, 1.0, 0.0]]),
        coh_laws=np.zeros(0, dtype=np.int32),
        coh_props=np.zeros((0, 6)),
        bc_dofs=bc_dofs.astype(np.int32),
        bc_vals=bc_vals,
        force_dofs=force_dofs,
        force_vec=force_vec,
        force_t1=np.zeros(tip_nodes.shape[0]),
        force_t2=np.full(tip_nodes.shape[0], t),
        trac_dofs=np.zeros((0, 4, 3), dtype=np.int32),
        trac_nodal_vec=np.zeros((0, 3)),
        trac_t1=np.zeros(0),
        trac_t2=np.zeros(0),
    )


def permute_nodes(problem: Problem, seed: int = 0) -> Problem:
    """Randomly renumber the nodes of a Problem (same physics, scrambled
    ids). Scrambling destroys the lex-lattice node ordering, so the
    unstructured path takes the fused-gather operator and SA-AMG: the
    deterministic way to exercise genuinely unstructured code paths on
    generated grids (the reference's parsers accept any node numbering,
    m_io.F90)."""
    rng = np.random.default_rng(seed)
    nnds = problem.coords.shape[0]
    perm = rng.permutation(nnds)  # new_id = inv[old_id]
    inv = np.empty(nnds, dtype=np.int64)
    inv[perm] = np.arange(nnds)
    pdim = problem.pdim

    def remap_dofs(d):
        node, comp = d // pdim, d % pdim
        return (inv[node] * pdim + comp).astype(d.dtype)

    blocks = {
        name: dataclasses.replace(b, conn=inv[b.conn].astype(b.conn.dtype))
        for name, b in problem.blocks.items()
    }
    return dataclasses.replace(
        problem,
        coords=problem.coords[perm],
        blocks=blocks,
        bc_dofs=remap_dofs(problem.bc_dofs),
        force_dofs=remap_dofs(problem.force_dofs),
        trac_dofs=remap_dofs(problem.trac_dofs),
    )
