"""Problem model: struct-of-arrays mesh + loads, host side.

Numpy copy of `fem_tpu/models/problem.py` (both parser paths). Replaces the
reference's array-of-structs `element` type and its global mesh state
(m_elems.F90:6-12, m_global.F90:17-44) with type-batched numpy arrays: one
`Block` per element type holding a dense (ne, nn) connectivity.

Everything here is host-side numpy, but for the mesh check's Jacobians,
which the host library's `fem_mesh_min_detj` (`csrc/mesh_check.cpp`, built
by `kernels_build`) computes; `fem_tpu_torch.models.system.System` moves the
problem to a torch device with the requested dtype.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np

from fem_tpu_torch import kernels_build
from fem_tpu_torch.io import inp, native
from fem_tpu_torch.ops import elements as element_lib

# Elements below which one more thread of the Jacobian check costs more to
# start than it saves.
ELEMENTS_PER_THREAD = 16384

# The last mesh check: the continuum elements whose Jacobians it checked,
# the most threads one block took, and the elements whose least det J is
# <= 0. `load` runs outside `stepper.run`, where `timing` keeps no counts.
last_check: dict = {}


@dataclasses.dataclass
class Block:
    """All elements of one type, batched."""

    eltype: str
    conn: np.ndarray  # (ne, nn) int32, 0-based global node ids
    mat: np.ndarray  # (ne,) int32, 0-based elastic material id (-1: none)
    nlmat: np.ndarray  # (ne,) int32, 0-based cohesive material id (-1: none)
    eids: np.ndarray  # (ne,) int32, original deck element index

    @property
    def ne(self) -> int:
        return self.conn.shape[0]

    @property
    def et(self) -> element_lib.ElementType:
        return element_lib.get(self.eltype)


@dataclasses.dataclass
class Problem:
    """A parsed, validated, type-batched FEM problem."""

    stype: str
    pdim: int
    t: float
    dt: float
    coords: np.ndarray  # (nnds, pdim)
    blocks: Dict[str, Block]
    mats: np.ndarray  # (nmts, 5)
    coh_laws: np.ndarray
    coh_props: np.ndarray  # (ncohmats, 6)
    # Dirichlet BCs, deduplicated per dof with last-write-wins (the reference
    # INSERTs per bc record: m_global.F90:296,451).
    bc_dofs: np.ndarray  # (nc,) int32 constrained dof ids
    bc_vals: np.ndarray  # (nc,) prescribed total displacement
    # Point forces
    force_dofs: np.ndarray  # (nfrcs, pdim) dof ids per force record
    force_vec: np.ndarray  # (nfrcs, pdim)
    force_t1: np.ndarray
    force_t2: np.ndarray
    # Tractions, precomputed to nodal-force form (ApplyTraction converts a
    # side traction to equal nodal forces vvec*area/nps, m_global.F90:343-368).
    trac_dofs: np.ndarray  # (ntrcs, nps, pdim) dof ids
    trac_nodal_vec: np.ndarray  # (ntrcs, pdim) = vec*area/nps
    trac_t1: np.ndarray  # raw deck values (FormRHS divides by dt: m_global.F90:414)
    trac_t2: np.ndarray
    nodal_bw: int = 0
    # Per-record per-node weights (ntrcs, nps_max): 1.0 for real side nodes,
    # 0.0 for padding rows when a deck mixes side node counts. None means
    # "all real" (uniform nps decks and the meshgen builders).
    trac_node_w: Optional[np.ndarray] = None

    @property
    def nnds(self) -> int:
        return self.coords.shape[0]

    @property
    def ndof(self) -> int:
        return self.nnds * self.pdim

    @property
    def nels(self) -> int:
        return sum(b.ne for b in self.blocks.values())

    @property
    def has_cohesive(self) -> bool:
        return self.coh_props.shape[0] > 0 and "coh" in self.blocks

    @property
    def nsteps(self) -> int:
        """Number of load increments: k = 1.. while dt*(k-1) < t
        (main.F90:216-219), replicated with the same float arithmetic."""
        k = 1
        while self.dt * (k - 1) < self.t:
            k += 1
        return k - 1

    @classmethod
    def from_deck(cls, deck: inp.Deck, validate: bool = True) -> "Problem":
        pdim = deck.pdim
        by_type: Dict[str, List[inp.RawElement]] = {}
        ids_by_type: Dict[str, List[int]] = {}
        for i, el in enumerate(deck.elements):
            by_type.setdefault(el.eltype, []).append(el)
            ids_by_type.setdefault(el.eltype, []).append(i)

        blocks: Dict[str, Block] = {}
        for eltype, els in by_type.items():
            et = element_lib.get(eltype)
            if et.pdim != pdim and eltype != "coh":
                raise ValueError(
                    f"{eltype} elements are {et.pdim}D but deck pdim={pdim}"
                )
            blocks[eltype] = Block(
                eltype=eltype,
                conn=np.stack([e.nodes for e in els]).astype(np.int32),
                mat=np.array([e.mat for e in els], dtype=np.int32),
                nlmat=np.array([e.nlmat for e in els], dtype=np.int32),
                eids=np.array(ids_by_type[eltype], dtype=np.int32),
            )

        if validate:
            _validate_mesh(deck.coords, blocks)

        def elem_lookup(eid: int):
            el = deck.elements[eid]
            return el.eltype, el.nodes

        return cls._assemble(
            stype=deck.stype, pdim=pdim, t=deck.t, dt=deck.dt,
            coords=deck.coords, blocks=blocks, mats=deck.mats,
            coh_laws=deck.coh_laws, coh_props=deck.coh_props,
            bc_node=deck.bc_node, bc_flags=deck.bc_flags,
            bc_vals_in=deck.bc_vals,
            force_node=deck.force_node, force_vec=deck.force_vec,
            force_t1=deck.force_t1, force_t2=deck.force_t2,
            trac_el=deck.trac_el, trac_side=deck.trac_side,
            trac_vec=deck.trac_vec, trac_t1=deck.trac_t1,
            trac_t2=deck.trac_t2, nodal_bw=deck.nodal_bw,
            elem_lookup=elem_lookup,
        )

    @classmethod
    def from_flat(cls, f: dict) -> "Problem":
        """Build from the native engine's flat arrays (io.native.parse_flat)
        without per-element Python objects (fem_tpu `problem.py:148-190`)."""
        etypes = f["elem_type"]
        conn = f["elem_conn"]
        blocks: Dict[str, Block] = {}
        for code, name in enumerate(element_lib.TYPE_ORDER):
            mask = etypes == code
            if not mask.any():
                continue
            blocks[name] = Block(
                eltype=name,
                conn=np.ascontiguousarray(
                    conn[mask][:, : element_lib.get(name).nnodes]),
                mat=f["elem_mat"][mask],
                nlmat=f["elem_nlmat"][mask],
                eids=np.nonzero(mask)[0].astype(np.int32),
            )
        _validate_mesh(f["coords"], blocks)

        def elem_lookup(eid: int):
            name = element_lib.TYPE_ORDER[int(etypes[eid])]
            return name, conn[eid, : element_lib.get(name).nnodes]

        return cls._assemble(
            stype=f["stype"], pdim=f["pdim"], t=f["t"], dt=f["dt"],
            coords=f["coords"], blocks=blocks, mats=f["mats"],
            coh_laws=f["coh_laws"], coh_props=f["coh_props"],
            bc_node=f["bc_node"], bc_flags=f["bc_flags"],
            bc_vals_in=f["bc_vals"],
            force_node=f["force_node"], force_vec=f["force_vec"],
            force_t1=f["force_t1"], force_t2=f["force_t2"],
            trac_el=f["trac_el"], trac_side=f["trac_side"],
            trac_vec=f["trac_vec"], trac_t1=f["trac_t1"],
            trac_t2=f["trac_t2"], nodal_bw=f["nodal_bw"],
            elem_lookup=elem_lookup,
        )

    @classmethod
    def from_reference(cls, p) -> "Problem":
        """Copy any object with the fields of `fem_tpu.models.problem.Problem`
        (blocks with eltype/conn/mat/nlmat/eids) into this package's Problem,
        every array as a fresh numpy copy. This is the state handed across
        when both packages must solve the very same problem."""
        blocks = {
            name: Block(
                eltype=b.eltype,
                conn=np.array(b.conn), mat=np.array(b.mat),
                nlmat=np.array(b.nlmat), eids=np.array(b.eids),
            )
            for name, b in p.blocks.items()
        }
        arrays = {
            f.name: np.array(getattr(p, f.name))
            for f in dataclasses.fields(cls)
            if f.name not in ("stype", "pdim", "t", "dt", "blocks",
                              "nodal_bw", "trac_node_w")
        }
        w = getattr(p, "trac_node_w", None)
        return cls(
            stype=str(p.stype), pdim=int(p.pdim), t=float(p.t),
            dt=float(p.dt), blocks=blocks, nodal_bw=int(p.nodal_bw),
            trac_node_w=None if w is None else np.array(w), **arrays,
        )

    @classmethod
    def _assemble(cls, *, stype, pdim, t, dt, coords, blocks, mats, coh_laws,
                  coh_props, bc_node, bc_flags, bc_vals_in, force_node,
                  force_vec, force_t1, force_t2, trac_el, trac_side, trac_vec,
                  trac_t1, trac_t2, nodal_bw, elem_lookup) -> "Problem":
        # BC dof table, vectorized, last write wins per dof (the reference
        # INSERTs per bc record: m_global.F90:296,451).
        constrained = bc_flags == 0  # BC_PRESENT
        rec, comp = np.nonzero(constrained)
        dofs = bc_node[rec].astype(np.int64) * pdim + comp
        vals = bc_vals_in[rec, comp]
        if dofs.size:
            uniq, inv = np.unique(dofs, return_inverse=True)
            last = np.full(uniq.shape[0], -1)
            np.maximum.at(last, inv, np.arange(dofs.shape[0]))
            bc_dofs = uniq.astype(np.int32)
            bc_vals = vals[last]
        else:
            bc_dofs = np.zeros(0, dtype=np.int32)
            bc_vals = np.zeros(0)

        force_dofs = (
            force_node[:, None].astype(np.int64) * pdim
            + np.arange(pdim)[None, :]
        ).astype(np.int32)

        # Tractions -> static nodal-force form (ApplyTraction converts a side
        # traction to equal nodal forces vvec*area/nps, m_global.F90:343-368).
        ntrcs = trac_el.shape[0]
        trac_node_w = None
        if ntrcs:
            # Size by the MAX side node count over all records: a 3D deck may
            # mix tri faces (3 nodes) and quad faces (4 nodes). Padded rows
            # point at dof 0 with weight 0.0.
            nps_max = max(
                element_lib.get(elem_lookup(int(e))[0]).nps for e in trac_el
            )
            trac_dofs = np.zeros((ntrcs, nps_max, pdim), dtype=np.int32)
            trac_nodal = np.zeros((ntrcs, pdim))
            trac_node_w = np.zeros((ntrcs, nps_max))
            for i in range(ntrcs):
                name, nodes = elem_lookup(int(trac_el[i]))
                et = element_lib.get(name)
                side = int(trac_side[i]) - 1
                snodes = nodes[et.sides[side]]
                area = _side_area(coords[snodes])
                trac_nodal[i] = trac_vec[i] * area / et.nps
                trac_dofs[i, : et.nps] = (
                    snodes[:, None].astype(np.int64) * pdim
                    + np.arange(pdim)[None, :]
                )
                trac_node_w[i, : et.nps] = 1.0
        else:
            trac_dofs = np.zeros((0, 2, pdim), dtype=np.int32)
            trac_nodal = np.zeros((0, pdim))

        return cls(
            stype=stype, pdim=pdim, t=t, dt=dt, coords=coords, blocks=blocks,
            mats=mats, coh_laws=coh_laws, coh_props=coh_props,
            bc_dofs=bc_dofs, bc_vals=bc_vals, force_dofs=force_dofs,
            force_vec=force_vec, force_t1=force_t1, force_t2=force_t2,
            trac_dofs=trac_dofs, trac_nodal_vec=trac_nodal,
            trac_t1=trac_t1, trac_t2=trac_t2, nodal_bw=nodal_bw,
            trac_node_w=trac_node_w,
        )


def _side_area(pts: np.ndarray) -> float:
    """Side measure: edge length (2D, 2 nodes), tri area (3 nodes), quad area
    (4 nodes) — EdgeAreaNodes* (m_elems.F90:282-293,366-378,469-482,583-599)."""
    n, d = pts.shape
    if n == 2:
        return float(np.linalg.norm(pts[0] - pts[1]))
    p = np.pad(pts, ((0, 0), (0, 3 - d))) if d < 3 else pts
    if n == 3:
        return float(0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0])))
    if n == 4:
        a1 = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        a2 = 0.5 * np.linalg.norm(np.cross(p[2] - p[0], p[3] - p[0]))
        return float(a1 + a2)
    raise ValueError(f"unsupported side node count {n}")


def _min_detj(coords: np.ndarray, conn: np.ndarray,
              et: element_lib.ElementType, threads: int):
    """Each element's least det J over its integration points, (ne,), and
    the count of elements where it is <= 0: the host library's
    `fem_mesh_min_detj` on `threads` threads. Every id of `conn` must index
    a row of `coords`."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    if coords.ndim != 2 or coords.shape[1] != et.pdim:
        raise ValueError(f"{et.name} elements are {et.pdim}D but the "
                         f"coordinates are {coords.shape[1:]}")
    if conn.ndim != 2 or conn.shape[1] != et.nnodes:
        raise ValueError(f"{et.name} connectivity {conn.shape} is not "
                         f"(ne, {et.nnodes})")
    dN = np.ascontiguousarray(et.dN, dtype=np.float64)
    out = np.empty(conn.shape[0])
    bad = kernels_build.host_library().fem_mesh_min_detj(
        coords.ctypes.data, et.pdim, conn.ctypes.data, conn.shape[0],
        et.nnodes, dN.ctypes.data, et.nip, threads, out.ctypes.data)
    if bad < 0:
        raise ValueError(f"no Jacobian check for {et.name} elements")
    return out, bad


def _validate_mesh(coords: np.ndarray, blocks: Dict[str, Block]) -> None:
    """Fail fast on out-of-range ids; warn on inverted/degenerate continuum
    elements (which the reference lets through silently, producing
    negative-definite or NaN stiffness). The ids are checked before any
    coordinate is read."""
    nnds = coords.shape[0]
    last_check.clear()
    checked = most_threads = total_bad = 0
    for b in blocks.values():
        if b.conn.min() < 0 or b.conn.max() >= nnds:
            raise ValueError(
                f"{b.eltype}: node id out of range [1, {nnds}] in deck"
            )
        if b.eltype == "coh":
            continue
        threads = kernels_build.host_threads(b.ne, ELEMENTS_PER_THREAD)
        _, bad = _min_detj(coords, b.conn, b.et, threads)
        checked += b.ne
        most_threads = max(most_threads, threads)
        total_bad += bad
        if bad:
            warnings.warn(
                f"{bad} {b.eltype} element(s) have non-positive Jacobian "
                "(inverted or degenerate); stiffness will be wrong",
                stacklevel=2,
            )
    last_check.update(elements=checked, threads=most_threads, bad=total_bad)


def load(path_or_text, backend: str = "auto") -> Problem:
    """Parse a deck and build the Problem in one call (fem_tpu
    `problem.py:303-318`).

    backend: "auto" uses the native C++ parser (native/libfemmesh.so) when
    it is built, else the pure-Python one; "python" / "native" force a
    choice, and "native" without the library raises.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown parser backend {backend!r}")
    if backend != "python":
        if native.available():
            return Problem.from_flat(native.parse_flat(str(path_or_text)))
        if backend == "native":
            raise RuntimeError("native mesh engine not built (make -C native)")
    return Problem.from_deck(inp.parse(path_or_text))
