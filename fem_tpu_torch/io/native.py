"""ctypes bindings for the native mesh engine (native/libfemmesh.so).

The port's own copy of `fem_tpu/io/native.py:71-274`; the C++ engine is
backend-neutral host code and is shared by both packages as it is. It covers
the reference's host-side native roles — deck parsing (m_io.F90), METIS
partitioning (m_io.F90:137) — with host-side replacements (a flat-array
parser, RCB partitioning); the library's Morton ordering is not bound, since
nothing in the port orders elements. `available()` is False when the
library has not been built; the parser then raises RuntimeError, and
rcb_partition (the `--shards` writer's partitioner) takes its numpy form,
as fem_tpu's does.

Build with `make -C native` (plain C ABI, bound with ctypes).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from fem_tpu_torch.io import inp

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libfemmesh.so",
)

_MAX_NODES = 8
_TYPE_NAMES = ("tri", "qua", "tet", "hex", "coh")
_TYPE_NN = (3, 4, 4, 8, 4)


class _FemDeck(ctypes.Structure):
    _fields_ = [
        ("stype", ctypes.c_int),
        ("pdim", ctypes.c_int),
        ("nodal_bw", ctypes.c_int),
        ("t", ctypes.c_double),
        ("dt", ctypes.c_double),
        ("nels", ctypes.c_int),
        ("nnds", ctypes.c_int),
        ("nmts", ctypes.c_int),
        ("ncohmats", ctypes.c_int),
        ("nceqs", ctypes.c_int),
        ("nfrcs", ctypes.c_int),
        ("ntrcs", ctypes.c_int),
        ("nbcs", ctypes.c_int),
        ("elem_type", ctypes.POINTER(ctypes.c_int)),
        ("elem_conn", ctypes.POINTER(ctypes.c_int)),
        ("elem_mat", ctypes.POINTER(ctypes.c_int)),
        ("elem_nlmat", ctypes.POINTER(ctypes.c_int)),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("mats", ctypes.POINTER(ctypes.c_double)),
        ("coh_law", ctypes.POINTER(ctypes.c_int)),
        ("coh_props", ctypes.POINTER(ctypes.c_double)),
        ("bc_node", ctypes.POINTER(ctypes.c_int)),
        ("bc_flags", ctypes.POINTER(ctypes.c_int)),
        ("bc_vals", ctypes.POINTER(ctypes.c_double)),
        ("f_node", ctypes.POINTER(ctypes.c_int)),
        ("f_vec", ctypes.POINTER(ctypes.c_double)),
        ("f_win", ctypes.POINTER(ctypes.c_double)),
        ("t_el", ctypes.POINTER(ctypes.c_int)),
        ("t_side", ctypes.POINTER(ctypes.c_int)),
        ("t_vec", ctypes.POINTER(ctypes.c_double)),
        ("t_win", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 256),
    ]


_lib = None


def _load():
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fem_parse_deck_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_FemDeck)
        ]
        lib.fem_parse_deck_file.restype = ctypes.c_int
        lib.fem_parse_deck.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_FemDeck)
        ]
        lib.fem_parse_deck.restype = ctypes.c_int
        lib.fem_free_deck.argtypes = [ctypes.POINTER(_FemDeck)]
        lib.fem_rcb_partition.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_np(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype=dtype)
    arr = np.ctypeslib.as_array(ptr, shape=(n,))
    return arr.reshape(shape).astype(dtype, copy=True)


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native mesh engine not built (make -C native)")
    return lib


def parse_flat(path_or_text: str) -> dict:
    """Parse a deck with the native engine; returns flat numpy arrays
    (no per-element Python objects — the fast path for large decks)."""
    lib = _require()
    d = _FemDeck()
    if "\n" in path_or_text:
        data = path_or_text.encode()
        rc = lib.fem_parse_deck(data, len(data), ctypes.byref(d))
    else:
        rc = lib.fem_parse_deck_file(path_or_text.encode(), ctypes.byref(d))
    if rc != 0:
        msg = d.error.decode()
        lib.fem_free_deck(ctypes.byref(d))
        raise ValueError(f"native deck parse failed: {msg}")
    try:
        pdim = d.pdim
        f_win = _as_np(d.f_win, (d.nfrcs, 2), float)
        t_win = _as_np(d.t_win, (d.ntrcs, 2), float)
        return dict(
            stype={0: "implicit", 1: "explicit"}.get(d.stype, "other"),
            pdim=pdim,
            nodal_bw=d.nodal_bw,
            t=d.t,
            dt=d.dt,
            nceqs=d.nceqs,
            elem_type=_as_np(d.elem_type, (d.nels,), np.int32),
            elem_conn=_as_np(d.elem_conn, (d.nels, _MAX_NODES), np.int32),
            elem_mat=_as_np(d.elem_mat, (d.nels,), np.int32),
            elem_nlmat=_as_np(d.elem_nlmat, (d.nels,), np.int32),
            coords=_as_np(d.coords, (d.nnds, pdim), float),
            mats=_as_np(d.mats, (d.nmts, 5), float),
            coh_laws=_as_np(d.coh_law, (d.ncohmats,), np.int32),
            coh_props=_as_np(d.coh_props, (d.ncohmats, 6), float),
            bc_node=_as_np(d.bc_node, (d.nbcs,), np.int32),
            bc_flags=_as_np(d.bc_flags, (d.nbcs, pdim), np.int32),
            bc_vals=_as_np(d.bc_vals, (d.nbcs, pdim), float),
            force_node=_as_np(d.f_node, (d.nfrcs,), np.int32),
            force_vec=_as_np(d.f_vec, (d.nfrcs, pdim), float),
            force_t1=f_win[:, 0].copy(),
            force_t2=f_win[:, 1].copy(),
            trac_el=_as_np(d.t_el, (d.ntrcs,), np.int32),
            trac_side=_as_np(d.t_side, (d.ntrcs,), np.int32),
            trac_vec=_as_np(d.t_vec, (d.ntrcs, pdim), float),
            trac_t1=t_win[:, 0].copy(),
            trac_t2=t_win[:, 1].copy(),
        )
    finally:
        lib.fem_free_deck(ctypes.byref(d))


def parse(path_or_text: str) -> inp.Deck:
    """Parse a deck with the native engine; returns an inp.Deck, field for
    field what inp.parse returns."""
    f = parse_flat(path_or_text)
    elements = [
        inp.RawElement(_TYPE_NAMES[t], f["elem_conn"][e, :_TYPE_NN[t]].copy(),
                       int(f["elem_mat"][e]), int(f["elem_nlmat"][e]))
        for e, t in enumerate(f["elem_type"].tolist())
    ]
    fields = {k: v for k, v in f.items() if not k.startswith("elem_")}
    return inp.Deck(elements=elements, **fields)


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Equal-count recursive coordinate bisection (METIS replacement): split
    the widest axis at the element count's share, recursively. The numpy
    form, taken only when the library is not built, gives the library's
    parts wherever no two centroids tie on a split coordinate at the cut
    (there the library's std::nth_element is free to put either first)."""
    lib = _load()
    if lib is None:
        return _rcb_partition_numpy(centroids, nparts)
    ne, pdim = centroids.shape
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    out = np.empty(ne, dtype=np.int32)
    lib.fem_rcb_partition(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ne, pdim, nparts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _rcb_partition_numpy(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """rcb_partition without the library (femmesh.cpp's rcb_recurse): the
    first axis of the widest extent, `len * left // nparts` elements to the
    left, by a stable sort."""
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    out = np.empty(c.shape[0], dtype=np.int32)

    def rec(ids, part_lo, n_parts):
        if n_parts <= 1:
            out[ids] = part_lo
            return
        axis = int(np.argmax(c[ids].max(axis=0) - c[ids].min(axis=0)))
        left = n_parts // 2
        k = len(ids) * left // n_parts
        ids = ids[np.argsort(c[ids, axis], kind="stable")]
        rec(ids[:k], part_lo, left)
        rec(ids[k:], part_lo + left, n_parts - left)

    rec(np.arange(c.shape[0]), 0, nparts)
    return out
