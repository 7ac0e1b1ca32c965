"""The native VTK writer (`fem_tpu_torch.io.vtk`, text formatted by the host
library's `fem_vtk_text`) against fem_tpu's Python writer, byte for byte, and
`cells_in_deck_order`'s table against the sort by eid."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from fem_tpu.io import vtk as j_vtk
from fem_tpu_torch.io import vtk
from fem_tpu_torch.models.problem import Block

# Values at the edges of F0.d: signed zeros, tiny negatives that round to
# "-.000000", decimal ties (exact in binary: 0.0625, 0.0078125; not exact:
# 0.0005, 2.5e-7, 1.0005), large magnitudes, NaN and the infinities.
EDGES = [0.0, -0.0, -1e-9, -4e-4, 4e-4, 0.0005, -0.0005, 2.5e-7, 1.0005,
         0.0625, -0.0625, 0.0078125, 0.9999995, -0.9995, 1e15, -1e15, 1e20,
         -1e20, 1.7976931348623157e308, np.nan, -np.nan, np.inf, -np.inf,
         5e-324]


def _field(rng, shape, scale):
    x = rng.standard_normal(shape) * scale
    flat = x.reshape(-1)
    at = rng.choice(flat.shape[0], size=min(len(EDGES), flat.shape[0]),
                    replace=False)
    flat[at] = EDGES[:at.shape[0]]
    return x


def _mesh(kind, rng, nnds, ne):
    """(pdim, [(vtk_id, nodes)]) of a seeded mesh of the kind."""
    if kind == "quad2d":
        return 2, [(9, rng.integers(0, nnds, 4)) for _ in range(ne)]
    if kind == "tri_quad":
        return 2, [(5, rng.integers(0, nnds, 3)) if rng.random() < 0.4
                   else (9, rng.integers(0, nnds, 4)) for _ in range(ne)]
    return 3, [(12, rng.integers(0, nnds, 8)) for _ in range(ne)]


def _inputs(kind, cpdim, dtype, seed=0, nnds=300, ne=250):
    rng = np.random.default_rng(seed)
    pdim, pairs = _mesh(kind, rng, nnds, ne)
    pairs = [(v, n.astype(dtype)) for v, n in pairs]
    coords = _field(rng, (nnds, pdim), 10.0)
    stress = _field(rng, (nnds, cpdim), 1e4)
    disp = _field(rng, (nnds * pdim,), 1e-3)
    return coords, pairs, stress, disp


@pytest.mark.parametrize("route", ["table", "list"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("cpdim", [3, 4, 6])
@pytest.mark.parametrize("kind", ["quad2d", "tri_quad", "hex3d"])
def test_bytes_identical_to_fem_tpu(tmp_path, kind, cpdim, dtype, route):
    coords, pairs, stress, disp = _inputs(kind, cpdim, dtype)
    cells = vtk.CellTable.pack(pairs) if route == "table" else pairs
    if route == "table":
        assert cells.nodes.dtype == dtype
    vtk.write(str(tmp_path / "a.vtk"), coords, cells, stress, disp)
    assert vtk.last_write["route"] == route
    j_vtk.write(str(tmp_path / "b.vtk"), coords, pairs, stress, disp)
    ours = (tmp_path / "a.vtk").read_bytes()
    assert ours == (tmp_path / "b.vtk").read_bytes()
    assert vtk.last_write["bytes"] == len(ours)


def test_bytes_do_not_depend_on_threads(tmp_path):
    """The C entry point at explicit thread counts, more than one chunk
    per section at each, gives the same bytes as fem_tpu's writer."""
    coords, pairs, stress, disp = _inputs("tri_quad", 3, np.int32, seed=3,
                                          nnds=5000, ne=4000)
    j_vtk.write(str(tmp_path / "b.vtk"), coords, pairs, stress, disp)
    want = (tmp_path / "b.vtk").read_bytes()
    table = vtk.CellTable.pack(pairs)
    for threads in (1, 2, 3, 7, 8, 32):
        with vtk._text(coords, table, stress, disp, threads) as text:
            assert bytes(text) == want, threads


def test_devnull_formats_every_value(tmp_path):
    coords, pairs, stress, disp = _inputs("quad2d", 3, np.int64, seed=5)
    vtk.write(str(tmp_path / "a.vtk"), coords, pairs, stress, disp)
    size = (tmp_path / "a.vtk").stat().st_size
    vtk.last_write.clear()
    vtk.write(os.devnull, coords, pairs, stress, disp)
    assert vtk.last_write == dict(route="list", bytes=size, threads=1)


def test_threads_follow_rows_and_cpus(tmp_path):
    coords, pairs, stress, disp = _inputs("quad2d", 3, np.int32, seed=7,
                                          nnds=40000, ne=30000)
    vtk.write(os.devnull, coords, pairs, stress, disp)
    rows = 3 * 40000 + 2 * 30000
    assert vtk.last_write["threads"] == max(1, min(
        len(os.sched_getaffinity(0)), rows // vtk.ROWS_PER_THREAD))


def test_cells_in_deck_order_sorts_by_eid():
    """A deck that lists its elements out of type order, with tri, quad and
    cohesive blocks of 3 and 4 nodes: the table's pairs are the sort by eid
    over the blocks' rows."""
    rng = np.random.default_rng(11)
    eids = rng.permutation(60).astype(np.int32)
    sizes = {"tri": 3, "qua": 4, "coh": 4}
    blocks, lo = {}, 0
    for name, ne in (("qua", 25), ("tri", 20), ("coh", 15)):
        conn = rng.integers(0, 80, (ne, sizes[name])).astype(np.int32)
        none = np.full(ne, -1, np.int32)
        blocks[name] = Block(name, conn, none, none, eids[lo:lo + ne])
        lo += ne
    problem = types.SimpleNamespace(blocks=blocks)
    items = []
    for b in blocks.values():
        for j in range(b.ne):
            items.append((int(b.eids[j]), b.et.vtk_id, b.conn[j]))
    items.sort(key=lambda x: x[0])
    table = vtk.cells_in_deck_order(problem)
    assert isinstance(table, vtk.CellTable) and len(table) == len(items)
    for (vtk_id, nodes), (_, want_id, want) in zip(table, items):
        assert type(vtk_id) is int and vtk_id == want_id
        assert nodes.dtype == want.dtype and np.array_equal(nodes, want)
    assert [v for v, _ in table[5:9]] == [x[1] for x in items[5:9]]
    assert np.array_equal(table[-1][1], items[-1][2])


def test_import_builds_and_loads_nothing():
    """Importing the writer and the CLI neither builds nor loads a native
    library; the first write does."""
    code = (
        "import fem_tpu_torch.cli, fem_tpu_torch.io.vtk\n"
        "from fem_tpu_torch import kernels_build as kb\n"
        "assert kb.host_library.cache_info().currsize == 0\n"
        "assert kb.library.cache_info().currsize == 0\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libfem_host' not in maps and 'libfem_kernels' not in maps\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
