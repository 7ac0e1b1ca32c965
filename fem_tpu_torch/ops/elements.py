"""Element library: registry, quadrature, shape functions — as static tables.

Numpy copy of `fem_tpu.ops.elements`. The reference element library
(m_elems.F90) dispatches on a runtime eltype string and memoizes shape
functions into ragged Fortran arrays (`shapeFuncMem`, m_elems.F90:32). Here
every element type is a frozen set of *host-side numpy tables* (quadrature
points/weights, N and dN/dxi at each integration point, side-node lists, the
nodal-stress extrapolation inverse) that the torch element code converts to
tensors of the caller's dtype and device.

Parity notes vs the reference:
  - Quadrature points, weights, and shape-function orderings match
    m_elems.F90 exactly (SamPtsTri/Qua/Tet/Hex/Coh, ShapeFuncPrecomp*).
  - The reference registry lists hex with 6 nodes (m_elems.F90:27) which makes
    its 3D hex path out-of-bounds/broken (SURVEY.md §2d.1). Here hex8 has the
    correct 8 nodes, matching the README's stated intent.
  - Nodal-stress extrapolation matrices (N2^-1, m_elems.F90:725-745) are
    precomputed with numpy at import time instead of LAPACK at startup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

_SQ3 = 1.0 / np.sqrt(3.0)


@dataclasses.dataclass(frozen=True)
class ElementType:
    """Static description of one element family.

    Attributes:
      name: 3-letter type tag used in .inp decks ("tri","qua","tet","hex","coh").
      pdim: spatial dimension of the element (m_elems.F90:48-59).
      nnodes: nodes per element (m_elems.F90:27, hex fixed to 8).
      nip: integration points (m_elems.F90:93-105).
      vtk_id: legacy VTK cell type id (m_elems.F90:108-120).
      ipoints: (nip, pdim) quadrature point coordinates.
      weights: (nip,) quadrature weights.
      N: (nip, nnodes) shape functions at the integration points.
      dN: (nip, pdim, nnodes) parametric shape-function gradients at the ips.
      sides: (nsides, nodes_per_side) 0-based local node indices per side
        (EdgeAreaNodes*, m_elems.F90:282-293,366-378,469-482,583-599).
      n2inv: (nnodes, nip) nodal extrapolation matrix N2^-1 when nip == nnodes
        (m_elems.F90:725-745), else None (nip==1 types broadcast instead).
    """

    name: str
    pdim: int
    nnodes: int
    nip: int
    vtk_id: int
    ipoints: np.ndarray
    weights: np.ndarray
    N: np.ndarray
    dN: np.ndarray
    sides: np.ndarray
    n2inv: Optional[np.ndarray]

    @property
    def nps(self) -> int:
        """Nodes per side (m_elems.F90:28,40-45)."""
        return int(self.sides.shape[1])

    @property
    def cpdim(self) -> int:
        """Stress/strain component count: 3 in 2D (xx,yy,xy), 6 in 3D."""
        return 3 if self.pdim == 2 else 6

    @property
    def ndof(self) -> int:
        return self.nnodes * self.pdim


def _tri3() -> ElementType:
    # 1-point rule, weight 1/2 (m_elems.F90:225-228).
    ip = np.array([[1.0 / 3.0, 1.0 / 3.0]])
    w = np.array([0.5])
    N = np.array([[1.0 - ip[0, 0] - ip[0, 1], ip[0, 0], ip[0, 1]]])
    dN = np.array([[[-1.0, 1.0, 0.0], [-1.0, 0.0, 1.0]]])  # m_elems.F90:273-279
    sides = np.array([[0, 1], [1, 2], [2, 0]])  # m_elems.F90:282-293
    return ElementType("tri", 2, 3, 1, 5, ip, w, N, dN, sides, None)


def _qua4() -> ElementType:
    # 2x2 Gauss, ordering (-,-),(-,+),(+,-),(+,+) (m_elems.F90:311-315).
    ip = np.array([[-_SQ3, -_SQ3], [-_SQ3, _SQ3], [_SQ3, -_SQ3], [_SQ3, _SQ3]])
    w = np.ones(4)
    e, n = ip[:, 0], ip[:, 1]
    N = 0.25 * np.stack(
        [(1 - e) * (1 - n), (1 + e) * (1 - n), (1 + e) * (1 + n), (1 - e) * (1 + n)],
        axis=1,
    )  # m_elems.F90:349-352
    dN = np.empty((4, 2, 4))
    for i in range(4):
        ei, ni = e[i], n[i]
        dN[i, 0] = 0.25 * np.array([-(1 - ni), (1 - ni), (1 + ni), -(1 + ni)])
        dN[i, 1] = 0.25 * np.array([-(1 - ei), -(1 + ei), (1 + ei), (1 - ei)])
    sides = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])  # m_elems.F90:366-378
    n2inv = np.linalg.inv(N)  # nip == nnodes (m_elems.F90:735-741)
    return ElementType("qua", 2, 4, 4, 9, ip, w, N, dN, sides, n2inv)


def _tet4() -> ElementType:
    # 1-point rule, weight 1/6 (m_elems.F90:398-401).
    ip = np.array([[0.25, 0.25, 0.25]])
    w = np.array([1.0 / 6.0])
    N = np.array([[1.0 - 0.75, 0.25, 0.25, 0.25]])
    dN = np.array(
        [[[-1.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 1.0]]]
    )  # m_elems.F90:459-466
    sides = np.array([[0, 1, 3], [1, 2, 3], [0, 2, 3], [0, 1, 2]])  # :469-482
    return ElementType("tet", 3, 4, 1, 10, ip, w, N, dN, sides, None)


def _hex8() -> ElementType:
    # 2x2x2 Gauss, ordering per SamPtsHex (m_elems.F90:500-507).
    signs = np.array(
        [
            [-1, -1, -1],
            [1, -1, -1],
            [1, 1, -1],
            [-1, 1, -1],
            [-1, -1, 1],
            [1, -1, 1],
            [1, 1, 1],
            [-1, 1, 1],
        ],
        dtype=float,
    )
    ip = signs * _SQ3
    w = np.ones(8)
    # Trilinear shape functions; node ordering matches ShapeFuncPrecompHex
    # (m_elems.F90:557-564) which shares the same sign pattern as the ips.
    node_signs = signs.copy()
    N = np.empty((8, 8))
    dN = np.empty((8, 3, 8))
    for i in range(8):
        e, n, s = ip[i]
        for a in range(8):
            se, sn, ss = node_signs[a]
            N[i, a] = 0.125 * (1 + se * e) * (1 + sn * n) * (1 + ss * s)
            dN[i, 0, a] = 0.125 * se * (1 + sn * n) * (1 + ss * s)
            dN[i, 1, a] = 0.125 * sn * (1 + se * e) * (1 + ss * s)
            dN[i, 2, a] = 0.125 * ss * (1 + se * e) * (1 + sn * n)
    sides = np.array(
        [
            [0, 1, 5, 4],
            [1, 2, 6, 5],
            [2, 3, 7, 6],
            [3, 0, 4, 7],
            [0, 1, 2, 3],
            [4, 5, 6, 7],
        ]
    )  # m_elems.F90:587-593
    n2inv = np.linalg.inv(N)  # nip == nnodes -> extrapolation matrix
    return ElementType("hex", 3, 8, 8, 12, ip, w, N, dN, sides, n2inv)


def _coh4() -> ElementType:
    # 2-point Gauss on a line, xi = -/+ 1/sqrt(3) (m_elems.F90:618-622).
    cn = 0.5773502691896260  # reference's precomputed CN (m_elems.F90:608)
    ip = np.array([[-cn, 0.0], [cn, 0.0]])
    w = np.ones(2)
    e = ip[:, 0]
    # Paired-node shape functions: N3=N2, N4=N1 (m_elems.F90:642-645).
    N = np.stack(
        [0.5 * (1 - e), 0.5 * (1 + e), 0.5 * (1 + e), 0.5 * (1 - e)], axis=1
    )
    dN = np.tile(np.array([[-0.5, 0.5, 0.5, -0.5]]), (2, 2, 1)).reshape(2, 2, 4)
    sides = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])
    return ElementType("coh", 2, 4, 2, 9, ip, w, N, dN, sides, None)


REGISTRY: Dict[str, ElementType] = {
    et.name: et for et in (_tri3(), _qua4(), _tet4(), _hex8(), _coh4())
}

# Reference's registry order (m_elems.F90:26) — used for integer type codes in
# the native mesh engine and the .inp parser.
TYPE_ORDER: Tuple[str, ...] = ("tri", "qua", "tet", "hex", "coh")
TYPE_CODE: Dict[str, int] = {name: i for i, name in enumerate(TYPE_ORDER)}


def get(name: str) -> ElementType:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown element type {name!r}; known: {sorted(REGISTRY)}"
        ) from None
