"""fem_tpu_torch's `structured.detect` against fem_tpu's on canonical boxes,
reordered connectivities and every way a deck can fail to be a box; the
counter `detect_sorted` says whether the sorted comparison ran."""

import dataclasses

import numpy as np
import pytest

from fem_tpu.io import inp as j_inp
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.problem import Problem as JProblem
from fem_tpu.ops import structured as j_structured
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.ops import structured
from fem_tpu_torch.utils import timing


def with_conn(p, conn):
    (name, b), = p.blocks.items()
    return dataclasses.replace(
        p, blocks={name: dataclasses.replace(b, conn=conn)})


def with_coords(p, edit):
    coords = np.array(p.coords)
    edit(coords)
    return dataclasses.replace(p, coords=coords)


def shuffled(p):
    (b,) = p.blocks.values()
    order = np.random.default_rng(7).permutation(b.conn.shape[0])
    return with_conn(p, b.conn[order])


def rotated(p):
    (b,) = p.blocks.values()
    return with_conn(p, np.roll(b.conn, 1, axis=1))


def neighbour_swapped(p):
    """One entry of one element replaced by the next node id."""
    (b,) = p.blocks.values()
    conn = np.array(b.conn)
    conn[3, 2] += 1
    return with_conn(p, conn)


def moved(frac):
    """Node 5's x moved by `frac` of the x cell."""
    def edit(c):
        c[5, 0] += frac * (np.unique(c[:, 0])[1] - np.unique(c[:, 0])[0])
    return lambda p: with_coords(p, edit)


def nodes_swapped(p):
    """Two nodes' coordinates exchanged: every axis stays uniform, only the
    lattice test can tell."""
    def edit(c):
        c[[1, 7]] = c[[7, 1]]
    return with_coords(p, edit)


def uneven(p):
    """The largest y plane moved out by a fifth of a cell."""
    def edit(c):
        top = c[:, 1] == c[:, 1].max()
        c[top, 1] += 0.2 * (np.unique(c[:, 1])[1] - np.unique(c[:, 1])[0])
    return with_coords(p, edit)


def nan_coord(p):
    def edit(c):
        c[4, 1] = np.nan
    return with_coords(p, edit)


def two_materials(p):
    (name, b), = p.blocks.items()
    mat = np.array(b.mat)
    mat[::2] = 1
    return dataclasses.replace(
        p, mats=np.vstack([p.mats, p.mats]),
        blocks={name: dataclasses.replace(b, mat=mat)})


def hex_box(nx, ny, nz, **kw):
    return lambda: j_meshgen.hex_box_problem(nx, ny, nz, **kw)


def quad_grid(nx, ny):
    return lambda: j_meshgen.quad_grid_problem(nx, ny)


def strip():
    return JProblem.from_deck(j_inp.parse(j_meshgen.quad_strip_deck(6, 2)))


# name: (fem_tpu Problem builder, edit, accepted,
#        detect_sorted: 0 / 1 / None where the check stops before it)
CASES = {
    "hex_5x3x2": (hex_box(5, 3, 2), None, True, 0),
    "hex_2x3x5": (hex_box(2, 3, 5), None, True, 0),
    "quad_5x2": (quad_grid(5, 2), None, True, 0),
    "quad_2x5": (quad_grid(2, 5), None, True, 0),
    "strip_deck_6x2": (strip, None, True, 0),
    "hex_shuffled": (hex_box(4, 3, 2), shuffled, True, 1),
    "quad_shuffled": (quad_grid(5, 3), shuffled, True, 1),
    "hex_corners_rotated": (hex_box(4, 3, 2), rotated, True, 1),
    "quad_corners_rotated": (quad_grid(3, 4), rotated, True, 1),
    "hex_neighbour_swapped": (hex_box(4, 3, 2), neighbour_swapped, False, 1),
    "hex_nodes_permuted": (hex_box(4, 3, 2), j_meshgen.permute_nodes, False,
                           None),
    "quad_nodes_permuted": (quad_grid(4, 3), j_meshgen.permute_nodes, False,
                            None),
    "hex_jitter": (hex_box(3, 3, 3, jitter=0.3), None, False, None),
    "hex_moved_1e-6": (hex_box(4, 3, 2), moved(1e-6), False, None),
    "hex_moved_1e-13": (hex_box(4, 3, 2), moved(1e-13), False, None),
    "hex_coords_swapped": (hex_box(4, 3, 2), nodes_swapped, False, None),
    # cells below the lattice test's atol: the swap lies within it
    "hex_tiny_coords_swapped": (
        hex_box(3, 2, 2, lx=3e-13, ly=2e-13, lz=2e-13), nodes_swapped, True,
        0),
    "quad_coords_swapped": (quad_grid(4, 3), nodes_swapped, False, None),
    "hex_uneven": (hex_box(4, 3, 2), uneven, False, None),
    "quad_uneven": (quad_grid(4, 3), uneven, False, None),
    "hex_nan": (hex_box(4, 3, 2), nan_coord, False, None),
    "hex_two_materials": (hex_box(4, 3, 2), two_materials, False, None),
    "cohesive": (lambda: j_meshgen.cohesive_interface_problem(4, 2), None,
                 False, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_detect_matches_fem_tpu_case(case):
    build, edit, accepted, sorted_count = CASES[case]
    jp = build()
    if edit is not None:
        jp = edit(jp)
    tm = timing.Timers()
    with tm.active(), tm.span("detect") as span:
        got = structured.detect(Problem.from_reference(jp))
    assert got == j_structured.detect(jp)
    assert (got is not None) == accepted
    assert span.counters.get("detect_sorted") == sorted_count
