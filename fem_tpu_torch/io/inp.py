"""Parser for the reference's Abaqus-flavoured `.inp` text decks.

Byte-compatible with m_io.F90's list-directed reads (ReadParameters
m_io.F90:12-20, ReadElementsCoords :71-105, ReadDistMaterials :282-328,
ReadDistBcs :373-411, ReadDistForces :330-371, ReadDistTractions :414-475):

  line 1: stype pdim nodal_bw
  line 2: nels nnds nmts [ncohmats] nceqs nfrcs ntrcs nbcs   (8 or legacy 7)
  line 3: t dt [ignored trailing tokens]
  then: element lines (`eltype n1..nk mat [nlMat]`), coords, elastic
  materials (5 floats), cohesive materials (`seplaw props..`), BCs
  (`node flags.. vals..`), forces (`node f.. t1 t2`), tractions
  (`el side t.. t1 t2`).

Like Fortran list-directed input, each record consumes only as many tokens as
it needs, so trailing `!`-comments and extra tokens are ignored; blank lines
are skipped. The legacy 7-count header (examples/SNES_test/*, which predates
the cohesive-material split — SURVEY.md §2d.8) is auto-detected: ncohmats=0
and element lines without the trailing nlMat column are accepted.

Numpy copy of `fem_tpu.io.inp`, the pure-Python parser; the ctypes binding
to the native C++ mesh engine is `io/native.py`, whose `parse` returns the
same Deck.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, TextIO, Union

import numpy as np

from fem_tpu_torch.ops import elements as element_lib

# Xu-Needleman is seplaw 1 with 6 props (m_seplaw.F90:7-8).
SEPLAW_PROP_COUNTS = {1: 6}
ELASTIC_MAT_SIZE = 5  # m_elems.F90:22


@dataclasses.dataclass
class RawElement:
    eltype: str
    nodes: np.ndarray  # (nn,) 0-based global node ids
    mat: int  # 0-based material index, -1 for none (reference mat==0)
    nlmat: int  # 0-based cohesive-material index, -1 for none


@dataclasses.dataclass
class Deck:
    """Parsed deck, host-side numpy only (converted to device arrays by
    fem_tpu_torch.models.problem.Problem)."""

    stype: str
    pdim: int
    nodal_bw: int
    t: float
    dt: float
    nceqs: int
    elements: List[RawElement]
    coords: np.ndarray  # (nnds, pdim)
    mats: np.ndarray  # (nmts, 5): E, nu, visc, expn, density
    coh_laws: np.ndarray  # (ncohmats,) int seplaw ids
    coh_props: np.ndarray  # (ncohmats, 6)
    bc_node: np.ndarray  # (nbcs,) 0-based
    bc_flags: np.ndarray  # (nbcs, pdim) int; 0 == constrained (BC_PRESENT)
    bc_vals: np.ndarray  # (nbcs, pdim)
    force_node: np.ndarray  # (nfrcs,) 0-based
    force_vec: np.ndarray  # (nfrcs, pdim)
    force_t1: np.ndarray  # (nfrcs,) clamped to <= t (m_io.F90:357-358)
    force_t2: np.ndarray
    trac_el: np.ndarray  # (ntrcs,) 0-based global element ids
    trac_side: np.ndarray  # (ntrcs,) 1-based side ids (as in the deck)
    trac_vec: np.ndarray  # (ntrcs, pdim)
    trac_t1: np.ndarray  # raw file values; FormRHS divides them by dt
    trac_t2: np.ndarray

    @property
    def nnds(self) -> int:
        return self.coords.shape[0]

    @property
    def nels(self) -> int:
        return len(self.elements)


class _Tokens:
    """Fortran-list-directed-style token stream: records take what they need,
    the rest of the line (including `!` comments) is dropped."""

    def __init__(self, lines: Sequence[str]):
        self._lines = [self._clean(ln) for ln in lines]
        self._lines = [ln for ln in self._lines if ln]
        self._pos = 0

    @staticmethod
    def _clean(line: str) -> List[str]:
        toks: List[str] = []
        for tok in line.split():
            if tok.startswith("!"):
                break
            toks.append(tok)
        return toks

    def record(self) -> List[str]:
        if self._pos >= len(self._lines):
            raise ValueError("unexpected end of .inp deck")
        line = self._lines[self._pos]
        self._pos += 1
        return line

    def peek(self) -> Optional[List[str]]:
        if self._pos >= len(self._lines):
            return None
        return self._lines[self._pos]


def parse(source: Union[str, TextIO]) -> Deck:
    """Parse a deck from a path, deck text, or file object."""
    if hasattr(source, "read"):
        text = source.read()
    else:
        s = str(source)
        if "\n" in s:
            text = s
        else:
            with open(s, "r") as f:
                text = f.read()
    tk = _Tokens(text.splitlines())

    # Header line 1: stype pdim nodal_bw (m_io.F90:16)
    rec = tk.record()
    stype, pdim, nodal_bw = rec[0], int(rec[1]), int(rec[2])
    if pdim not in (2, 3):
        raise ValueError(f"pdim must be 2 or 3, got {pdim}")

    # Header line 2: canonical 8 counts, or legacy 7 (no ncohmats).
    counts = [int(x) for x in tk.record()]
    if len(counts) >= 8:
        nels, nnds, nmts, ncohmats, nceqs, nfrcs, ntrcs, nbcs = counts[:8]
    elif len(counts) == 7:
        nels, nnds, nmts, nceqs, nfrcs, ntrcs, nbcs = counts
        ncohmats = 0
    else:
        raise ValueError(f"expected 7 or 8 header counts, got {len(counts)}")

    # Header line 3: t dt (trailing tokens like output_frequency ignored,
    # m_io.F90:18).
    rec = tk.record()
    t, dt = float(rec[0]), float(rec[1])

    # Elements (m_io.F90:85-95): eltype nodes.. mat [nlMat]
    elems: List[RawElement] = []
    for _ in range(nels):
        rec = tk.record()
        eltype = rec[0]
        et = element_lib.get(eltype)
        nn = et.nnodes
        nodes = np.array([int(x) - 1 for x in rec[1 : 1 + nn]], dtype=np.int32)
        mat = int(rec[1 + nn]) - 1  # 0 in the deck means "no elastic material"
        nlmat = int(rec[2 + nn]) - 1 if len(rec) > 2 + nn else -1
        elems.append(RawElement(eltype, nodes, mat, nlmat))

    # Coordinates (m_io.F90:97-100).
    coords = np.empty((nnds, pdim))
    for i in range(nnds):
        rec = tk.record()
        coords[i] = [float(x) for x in rec[:pdim]]

    # Elastic materials: 5 floats each (m_io.F90:300-304).
    mats = np.empty((nmts, ELASTIC_MAT_SIZE))
    for i in range(nmts):
        rec = tk.record()
        mats[i] = [float(x) for x in rec[:ELASTIC_MAT_SIZE]]

    # Cohesive materials: seplaw id + its props (m_io.F90:307-315).
    coh_laws = np.zeros(ncohmats, dtype=np.int32)
    coh_props = np.zeros((ncohmats, 6))
    for i in range(ncohmats):
        rec = tk.record()
        law = int(rec[0])
        pc = SEPLAW_PROP_COUNTS.get(law)
        if pc is None:
            raise ValueError(f"unknown separation law {law}")
        coh_laws[i] = law
        coh_props[i, :pc] = [float(x) for x in rec[1 : 1 + pc]]

    if nceqs:
        # The reference parses no constraint-equation records and its nceqs
        # path indexes past the dof vector (m_global.F90:390-397, SURVEY §2d.4)
        # — all shipped decks have nceqs=0.
        raise NotImplementedError("constraint equations (nceqs>0) not supported")

    # BCs: node flags(pdim) vals(pdim); flag 0 == constrained (m_io.F90:396-399).
    bc_node = np.zeros(nbcs, dtype=np.int32)
    bc_flags = np.zeros((nbcs, pdim), dtype=np.int32)
    bc_vals = np.zeros((nbcs, pdim))
    for i in range(nbcs):
        rec = tk.record()
        bc_node[i] = int(rec[0]) - 1
        bc_flags[i] = [int(x) for x in rec[1 : 1 + pdim]]
        bc_vals[i] = [float(x) for x in rec[1 + pdim : 1 + 2 * pdim]]

    # Forces: node f(pdim) t1 t2, windows clamped to <= t (m_io.F90:354-359).
    force_node = np.zeros(nfrcs, dtype=np.int32)
    force_vec = np.zeros((nfrcs, pdim))
    force_t1 = np.zeros(nfrcs)
    force_t2 = np.zeros(nfrcs)
    for i in range(nfrcs):
        rec = tk.record()
        force_node[i] = int(rec[0]) - 1
        force_vec[i] = [float(x) for x in rec[1 : 1 + pdim]]
        force_t1[i] = min(float(rec[1 + pdim]), t)
        force_t2[i] = min(float(rec[2 + pdim]), t)

    # Tractions: el side t(pdim) t1 t2 (m_io.F90:436-439).
    trac_el = np.zeros(ntrcs, dtype=np.int32)
    trac_side = np.zeros(ntrcs, dtype=np.int32)
    trac_vec = np.zeros((ntrcs, pdim))
    trac_t1 = np.zeros(ntrcs)
    trac_t2 = np.zeros(ntrcs)
    for i in range(ntrcs):
        rec = tk.record()
        trac_el[i] = int(rec[0]) - 1
        trac_side[i] = int(rec[1])
        trac_vec[i] = [float(x) for x in rec[2 : 2 + pdim]]
        trac_t1[i] = float(rec[2 + pdim])
        trac_t2[i] = float(rec[3 + pdim])

    return Deck(
        stype=stype,
        pdim=pdim,
        nodal_bw=nodal_bw,
        t=t,
        dt=dt,
        nceqs=nceqs,
        elements=elems,
        coords=coords,
        mats=mats,
        coh_laws=coh_laws,
        coh_props=coh_props,
        bc_node=bc_node,
        bc_flags=bc_flags,
        bc_vals=bc_vals,
        force_node=force_node,
        force_vec=force_vec,
        force_t1=force_t1,
        force_t2=force_t2,
        trac_el=trac_el,
        trac_side=trac_side,
        trac_vec=trac_vec,
        trac_t1=trac_t1,
        trac_t2=trac_t2,
    )
