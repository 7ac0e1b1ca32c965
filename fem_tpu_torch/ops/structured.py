"""Structured-grid (stencil) elastic operator, in torch.

Port of `fem_tpu.ops.structured`. For meshes that ARE uniform boxes (the hex8
cantilever of the scale path included) every element shares one Jacobian,
so K.u needs no element gather: it is a 27-point (3D) or 9-point (2D)
stencil built from the reference element stiffness. Heterogeneous isotropic
materials use the linearity of k_e in the Lame parameters:
k_e = lam_e K_lam + mu_e K_mu.

One schedule per operator kind:
  - scalar material, 3D or 2D: cuda_kernels.stencil_matvec (kernel K2, the
    collapsed 27-point or 9-point stencil with exact boundary classes, on
    CUDA tensors; on CPU tensors its plain form) on tables built once per
    operator;
  - per-cell lam/mu fields: the cell form (corner gather, two products with
    K_lam and K_mu, corner scatter-add), in torch on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.ops import elements as element_lib
from fem_tpu_torch.ops import stiffness as stiff_ops
from fem_tpu_torch.ops.cuda_kernels import HEX_OFFSETS, QUAD_OFFSETS
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.utils import timing

_QUAD_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))  # (x, y) per node 1..4


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Uniform-geometry box-grid elastic operator.

    k_lam/k_mu: (ndof_e, ndof_e) reference stiffness split by Lame parameter.
    lam/mu: 0-dim tensors, or (*cells,) fields for heterogeneous material.
    shape: node-grid shape, (nnx, nny, nnz) in 3D and (nny, nnx) in 2D
    (y-major, as meshgen and make_example number the nodes).
    Derived once, here and in every dataclasses.replace copy, for scalar
    materials: k_ref = lam * k_lam + mu * k_mu and K2's tables.
    """

    k_lam: torch.Tensor
    k_mu: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    shape: Tuple[int, ...]
    k_ref: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)
    tables: Optional[cuda_kernels.StencilTables] = dataclasses.field(
        init=False, repr=False)

    def __post_init__(self):
        k_ref = tables = None
        if self.lam.dim() == 0:
            k_ref = self.lam * self.k_lam + self.mu * self.k_mu
            tables = cuda_kernels.stencil_tables(k_ref, self.shape)
        object.__setattr__(self, "k_ref", k_ref)
        object.__setattr__(self, "tables", tables)

    @property
    def pdim(self) -> int:
        return len(self.shape)

    @property
    def ndof(self) -> int:
        return int(np.prod(self.shape)) * self.pdim

    @property
    def offsets(self):
        return HEX_OFFSETS if self.pdim == 3 else QUAD_OFFSETS


def build(cell_sizes, node_shape, lam, mu, *, dtype=torch.float64,
          device) -> StencilOperator:
    """cell_sizes: element edge lengths (dx, dy[, dz]); node_shape: node counts
    per axis; lam/mu: scalars or per-cell fields. The reference pair
    k_lam/k_mu is formed by the element stiffness entry point of
    ops.stiffness with ne=2 ((lam, mu) = (1, 0) and (0, 1)), so in 3D it goes
    through kernel K1 on a CUDA device."""
    pdim = len(node_shape)
    et = element_lib.get("hex" if pdim == 3 else "qua")
    corners = np.array(HEX_OFFSETS if pdim == 3 else _QUAD_CORNERS, dtype=float)
    ec = timing.upload(corners * np.asarray(cell_sizes), dtype=dtype,
                       device=device)
    ecoords = torch.stack([ec, ec])
    ke = stiff_ops.element_stiffness_lame(
        et, ecoords,
        timing.upload([1.0, 0.0], dtype=dtype, device=device),
        timing.upload([0.0, 1.0], dtype=dtype, device=device),
    )
    return StencilOperator(
        k_lam=ke[0].contiguous(),
        k_mu=ke[1].contiguous(),
        lam=timing.upload(lam, dtype=dtype, device=device),
        mu=timing.upload(mu, dtype=dtype, device=device),
        shape=tuple(int(n) for n in node_shape),
    )


def detect(problem):
    """Recognize a uniform box-grid Problem and return a matching
    StencilOperator spec, or None.

    Accepts the canonical generated orderings (meshgen builders / the
    reference's make_example strips): 3D nodes numbered z-fastest
    ((i*(ny+1)+j)*(nz+1)+k), 2D y-major (row*nnx+col). Requires a single
    continuum block (qua/hex), one material, and uniform spacing per axis.

    The coordinates are checked in place, one axis at a time against its
    axis vector broadcast over the node grid. A connectivity in the
    canonical order (elements in generated order, corners in HEX_OFFSETS /
    _QUAD_CORNERS order) is checked column by column against each cell's
    base node plus the corner's offset, with no sort. Any other element or
    corner order is compared as sets of sorted rows, as fem_tpu does; the
    counter `detect_sorted` is 1 where that comparison ran, else 0.
    """
    names = [n for n in problem.blocks if n != "coh"]
    if "coh" in problem.blocks or len(names) != 1:
        return None
    b = problem.blocks[names[0]]
    if b.eltype not in ("qua", "hex"):
        return None
    if np.unique(b.mat).size != 1 or int(b.mat[0]) < 0:
        return None
    coords = problem.coords
    pdim = problem.pdim
    axes = []
    for j in range(pdim):
        vals = np.unique(coords[:, j])
        if vals.size < 2:
            return None
        d = np.diff(vals)
        if not np.allclose(d, d[0], rtol=1e-9, atol=1e-12):
            return None
        axes.append(vals)
    counts = [v.size for v in axes]
    if int(np.prod(counts)) != problem.nnds:
        return None

    if pdim == 3:
        nx, ny, nz = counts
        node_shape = (nx, ny, nz)
        grid_axis = (0, 1, 2)  # the node-grid dimension each axis runs along
        corners = [(ox * ny + oy) * nz + oz for ox, oy, oz in HEX_OFFSETS]
    else:
        nx, ny = counts
        node_shape = (ny, nx)  # y-major numbering
        grid_axis = (1, 0)
        corners = [x + y * nx for x, y in _QUAD_CORNERS]

    for j, g in enumerate(grid_axis):
        shape = [1] * pdim
        shape[g] = -1
        if not np.allclose(coords[:, j].reshape(node_shape),
                           axes[j].reshape(shape), rtol=1e-9, atol=1e-12):
            return None
    conn = b.conn
    # each cell's first corner: node (i, j[, k]) of the grid, i, j, k < n - 1
    base = np.arange(problem.nnds, dtype=conn.dtype).reshape(node_shape)[
        tuple(slice(0, n - 1) for n in node_shape)].reshape(-1)
    if conn.shape != (base.size, len(corners)):
        return None
    in_order = all(np.array_equal(conn[:, q], base + off)
                   for q, off in enumerate(corners))
    timing.count("detect_sorted", 0 if in_order else 1)
    if not in_order:
        # element or corner ORDER may differ; compare as sets via
        # lexicographic sort
        conn_expect = np.stack([base + off for off in corners], axis=1)
        a = np.sort(conn, axis=1)
        e = np.sort(conn_expect.astype(np.int32), axis=1)
        pa = np.lexsort(a.T)
        pe = np.lexsort(e.T)
        if not np.array_equal(a[pa], e[pe]):
            return None
    cell_sizes = tuple(float(v[1] - v[0]) for v in axes)
    E, nu = problem.mats[int(b.mat[0]), 0], problem.mats[int(b.mat[0]), 1]
    return dict(cell_sizes=cell_sizes, node_shape=node_shape, E=float(E),
                nu=float(nu))


def operator_for(system, spec) -> StencilOperator:
    """The stencil operator of a box that `detect` accepted, built from the
    material of the System's single block and not from spec["E"] /
    spec["nu"] (the deck's): System has made the plane-stress substitution
    there (pdim 2 only), so the stencil's K is the one its right-hand side
    and stress recovery assume."""
    (block,) = system.blocks.values()
    E, nu = (torch.tensor(float(block[k][0]), dtype=system.dtype)
             for k in ("E", "nu"))
    lam, mu = stiff_ops.lame(E, nu)
    return build(spec["cell_sizes"], spec["node_shape"], lam, mu,
                 dtype=system.dtype, device=system.device)


def _corner_slices(shape, off):
    """Slice of the node grid selecting each element's `off` corner."""
    return tuple(slice(o, o + n - 1) for o, n in zip(off, shape))


def _cell_form(op: StencilOperator, nodes):
    """K.u for per-cell lam/mu fields: (*shape, pdim) in and out. Gathers the
    corner values of every cell, applies k_lam and k_mu, scales by the
    fields and scatter-adds back to the corners (fem_tpu's _matmul_core)."""
    pdim, shape, offs = op.pdim, op.shape, op.offsets
    ue = torch.stack([nodes[_corner_slices(shape, off)] for off in offs],
                     dim=-2)  # (*cells, nn, pdim)
    cells = ue.shape[:pdim]
    ue = ue.reshape(-1, len(offs) * pdim)
    fe = (op.lam.reshape(-1, 1) * (ue @ op.k_lam.T)
          + op.mu.reshape(-1, 1) * (ue @ op.k_mu.T))
    fe = fe.reshape(*cells, len(offs), pdim)
    out = torch.zeros_like(nodes)
    for c, off in enumerate(offs):
        out[_corner_slices(shape, off)] += fe[..., c, :]
    return out


def matvec(op: StencilOperator, u):
    """K @ u for a flat (ndof,) vector."""
    if op.lam.dim() != 0:
        return _cell_form(op, u.reshape(*op.shape, op.pdim)).reshape(-1)
    return cuda_kernels.stencil_matvec(op.tables, u)


def matvec_g(op: StencilOperator, g):
    """K @ u on grid-shaped (*shape, pdim) vectors (the multigrid layout)."""
    return matvec(op, g.reshape(-1)).reshape(g.shape)


def diag(op: StencilOperator):
    """Diagonal of K: the corner scatter of k_ref's diagonal."""
    pdim, shape, offs = op.pdim, op.shape, op.offsets
    nn = len(offs)
    if op.lam.dim() == 0:
        dref = torch.diagonal(op.k_ref).reshape(nn, pdim)
        cells = tuple(n - 1 for n in shape)
        dcell = dref.expand(*cells, nn, pdim)
    else:
        d_lam = torch.diagonal(op.k_lam).reshape(nn, pdim)
        d_mu = torch.diagonal(op.k_mu).reshape(nn, pdim)
        dcell = op.lam[..., None, None] * d_lam + op.mu[..., None, None] * d_mu
    out = torch.zeros((*shape, pdim), dtype=op.k_lam.dtype,
                      device=op.k_lam.device)
    for c, off in enumerate(offs):
        out[_corner_slices(shape, off)] += dcell[..., c, :]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Slab-sharded apply (port of fem_tpu's matvec_sharded)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabStencil:
    """A StencilOperator cut into cell slabs along its leading axis: shard i
    holds, on its device, the operator of cells [start_i, end_i), whose node
    grid is planes [start_i, end_i] of the whole grid."""

    mesh: mesh_mod.DeviceMesh
    shape: Tuple[int, ...]  # the whole node grid
    bounds: Tuple[Tuple[int, int], ...]  # cell slabs
    ops: Tuple[StencilOperator, ...]

    @property
    def pdim(self) -> int:
        return len(self.shape)


def fields_to_blocks(op: StencilOperator, nd: int):
    """Per-cell material fields as nd disjoint cell slabs [(lam_i, mu_i)]
    (cells partition cleanly; only node planes overlap). None for a scalar
    material."""
    if op.lam.dim() == 0:
        return None
    return [(op.lam[s:e], op.mu[s:e])
            for s, e in mesh_mod.slab_bounds(op.shape[0] - 1, nd)]


def shard_slabs(op: StencilOperator, mesh: mesh_mod.DeviceMesh) -> SlabStencil:
    """Cut op into one cell slab per shard (a slab of no cells, one node
    plane, where there are more shards than cells). A scalar-material slab
    keeps the scalar, so its apply is K2 on the slab's own tables."""
    bounds = mesh_mod.slab_bounds(op.shape[0] - 1, mesh.size)
    fields = fields_to_blocks(op, mesh.size)
    if fields is None:
        lam, mu = (mesh_mod.replicate(mesh, x) for x in (op.lam, op.mu))
    else:
        lam, mu = (mesh_mod.scatter(mesh, list(f)) for f in zip(*fields))
    k_lam, k_mu = (mesh_mod.replicate(mesh, k) for k in (op.k_lam, op.k_mu))
    ops = tuple(
        StencilOperator(k_lam=k_lam[i], k_mu=k_mu[i], lam=lam[i], mu=mu[i],
                        shape=(e - s + 1,) + op.shape[1:])
        for i, (s, e) in enumerate(bounds))
    return SlabStencil(mesh=mesh, shape=op.shape, bounds=tuple(bounds),
                       ops=ops)


def matvec_sharded(sl: SlabStencil, u):
    """K @ u, u replicated: shard i applies its slab's operator to node
    planes [start_i, end_i] of u and writes them into a zero grid; one
    all-reduce sums the partial grids (the shared planes with them). Takes
    and returns a flat (ndof,) vector on shard 0's device."""
    gshape = sl.shape + (sl.pdim,)
    parts = []
    for (s, e), lop, ui in zip(sl.bounds, sl.ops,
                               mesh_mod.replicate(sl.mesh, u)):
        out = torch.zeros(gshape, dtype=ui.dtype, device=ui.device)
        out[s:e + 1] = matvec_g(lop, ui.view(gshape)[s:e + 1])
        parts.append(out.view(-1))
    return mesh_mod.all_reduce_sum(sl.mesh, parts)[0]
