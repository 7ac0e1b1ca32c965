"""The mesh check of `problem.load` (`models/problem._validate_mesh`): each
continuum element's least det J from the host library's `fem_mesh_min_detj`
(`csrc/mesh_check.cpp`) against numpy's einsum and det, and its ids,
warnings and counts against fem_tpu's `_validate_mesh` on the same arrays."""

import warnings

import numpy as np
import pytest

from fem_tpu.models import problem as j_problem
from fem_tpu_torch import kernels_build
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.ops import elements as element_lib
from test_3d_decks import MIXED_TRAC_DECK

TYPES = ("tri", "qua", "tet", "hex")

# Kuhn's six tetrahedra of a cube, on its corners numbered x + 2y + 4z.
_KUHN = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7),
         (0, 4, 5, 7), (0, 5, 1, 7))
# A node order of each type that turns the element inside out.
_INVERT = dict(tri=[0, 2, 1], qua=[0, 3, 2, 1], tet=[1, 0, 2, 3],
               hex=[4, 5, 6, 7, 0, 1, 2, 3])
# hex8 node order (elements._hex8): the corner x + 2y + 4z of each node.
_HEX = (0, 1, 3, 2, 4, 5, 7, 6)


def jittered_mesh(eltype, n=6, seed=0):
    """(coords, conn) of a lattice of n^pdim cells of `eltype`, nodes moved
    by up to 0.15 of the spacing, every element positively oriented."""
    rng = np.random.default_rng(seed)
    pdim = element_lib.get(eltype).pdim
    axes = np.meshgrid(*[np.arange(n + 1.0)] * pdim, indexing="ij")
    coords = np.stack([a.ravel() for a in axes], 1)
    coords += rng.uniform(-0.15, 0.15, coords.shape)
    stride = (n + 1) ** np.arange(pdim)[::-1]  # node id of (i, j[, k])
    corner = np.array(np.meshgrid(*[np.arange(n)] * pdim, indexing="ij"))
    base = np.tensordot(stride, corner, 1).ravel()
    # corner c (bits x, y[, z]) of each cell, as a node offset
    offs = np.array([sum(((c >> b) & 1) * stride[b] for b in range(pdim))
                     for c in range(2 ** pdim)])
    if eltype == "qua":
        local = [(0, 1, 3, 2)]
    elif eltype == "tri":
        local = [(0, 1, 3), (0, 3, 2)]
    elif eltype == "hex":
        local = [_HEX]
    else:
        local = _KUHN
    conn = np.concatenate([base[:, None] + offs[list(c)] for c in local])
    conn = conn.astype(np.int32)
    det = _einsum_det(coords, conn, eltype).min(axis=1)
    conn[det < 0, :2] = conn[det < 0, 1::-1]  # reorient the tets
    return coords, conn


def _einsum_det(coords, conn, eltype):
    """fem_tpu's route: det J at every integration point, (ne, nip)."""
    et = element_lib.get(eltype)
    return np.linalg.det(np.einsum("ipn,end->eipd", et.dN, coords[conn]))


def planted(eltype, seed=0):
    """A jittered mesh with one element inverted (element 3, its nodes in
    `_INVERT`'s order) and one degenerate (element 5, its nodes on the
    plane where the last coordinate is 0, so that det J is exactly 0)."""
    coords, conn = jittered_mesh(eltype, seed=seed)
    pdim = coords.shape[1]
    conn[3] = conn[3, _INVERT[eltype]]
    flat = np.zeros((conn.shape[1], pdim))
    flat[:, :-1] = np.random.default_rng(seed).uniform(
        0, 1, (conn.shape[1], pdim - 1))
    conn[5] = coords.shape[0] + np.arange(conn.shape[1])
    return np.concatenate([coords, flat]), conn


def blocks_of(module, eltype, conn):
    ne = conn.shape[0]
    return {eltype: module.Block(
        eltype=eltype, conn=conn, mat=np.zeros(ne, np.int32),
        nlmat=np.full(ne, -1, np.int32), eids=np.arange(ne, dtype=np.int32))}


def recorded(fn, *args):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn(*args)
    return [(w.category, str(w.message), w.filename) for w in caught]


@pytest.mark.parametrize("eltype", TYPES)
def test_min_detj_equals_einsum_det(eltype):
    coords, conn = jittered_mesh(eltype, seed=1)
    got, bad = problem_mod._min_detj(coords, conn, element_lib.get(eltype),
                                     threads=4)
    want = _einsum_det(coords, conn, eltype).min(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert bad == 0 and want.min() > 0


@pytest.mark.parametrize("eltype", TYPES)
def test_planted_elements_warn_as_fem_tpu(eltype):
    coords, conn = planted(eltype)
    want = recorded(j_problem._validate_mesh, coords,
                    blocks_of(j_problem, eltype, conn))
    got = recorded(problem_mod._validate_mesh, coords,
                   blocks_of(problem_mod, eltype, conn))
    assert got == want
    assert [m for _, m, _ in got] == [
        f"2 {eltype} element(s) have non-positive Jacobian (inverted or "
        "degenerate); stiffness will be wrong"]
    assert got[0][2] == __file__  # stacklevel=2: the caller's line
    least, bad = problem_mod._min_detj(coords, conn, element_lib.get(eltype),
                                       threads=2)
    assert bad == 2 and least[5] == 0.0 and least[3] < 0


@pytest.mark.parametrize("backend", ["native", "python"])
def test_mixed_deck_inverted_tet_warns_as_fem_tpu(backend):
    """The mixed 3D deck's tet has its apex below its base: inverted. Both
    callers, `from_flat` and `from_deck`, warn as fem_tpu's do."""
    def messages(load):
        return [m for _, m, _ in recorded(load, MIXED_TRAC_DECK, backend)]

    want = messages(j_problem.load)
    assert want == ["1 tet element(s) have non-positive Jacobian (inverted "
                    "or degenerate); stiffness will be wrong"]
    assert messages(problem_mod.load) == want
    assert problem_mod.last_check == dict(elements=2, threads=1, bad=1)


@pytest.mark.parametrize("where", ["-1", "nnds"])
def test_out_of_range_ids_raise_before_any_coordinate_is_read(
        where, monkeypatch):
    coords, conn = jittered_mesh("qua")
    conn[7, 2] = -1 if where == "-1" else coords.shape[0]
    with pytest.raises(ValueError) as want:
        j_problem._validate_mesh(coords, blocks_of(j_problem, "qua", conn))

    def never(*args, **kw):
        raise AssertionError("coordinates read before the id check")

    monkeypatch.setattr(problem_mod, "_min_detj", never)
    with pytest.raises(ValueError) as got:
        problem_mod._validate_mesh(coords,
                                   blocks_of(problem_mod, "qua", conn))
    assert str(got.value) == str(want.value)
    assert problem_mod.last_check == {}


def test_coh_blocks_are_skipped():
    """Zero-thickness cohesive elements have det J = 0 everywhere: neither
    package warns on them, and they are not counted as checked."""
    coords, conn = jittered_mesh("qua", n=4)
    coh = conn[:3].copy()
    coh[:, 3], coh[:, 2] = coh[:, 0], coh[:, 1]
    for module in (j_problem, problem_mod):
        blocks = blocks_of(module, "qua", conn)
        blocks["coh"] = blocks_of(module, "coh", coh)["coh"]
        assert recorded(module._validate_mesh, coords, blocks) == []
    assert problem_mod.last_check == dict(elements=conn.shape[0], threads=1,
                                          bad=0)


@pytest.mark.parametrize("eltype", TYPES)
def test_threads_give_identical_arrays(eltype):
    coords, conn = planted(eltype, seed=2)
    et = element_lib.get(eltype)
    want, want_bad = problem_mod._min_detj(coords, conn, et, threads=1)
    for threads in (2, 3, 7, 8, 32, 1_000):
        got, bad = problem_mod._min_detj(coords, conn, et, threads=threads)
        assert got.tobytes() == want.tobytes() and bad == want_bad, threads


def test_nan_is_the_least_and_not_bad():
    """A NaN coordinate makes its elements' least det J NaN, as numpy's min
    does, and NaN is not <= 0."""
    coords, conn = jittered_mesh("qua", n=3)
    coords[conn[4, 0], 1] = np.nan
    got, bad = problem_mod._min_detj(coords, conn, element_lib.get("qua"),
                                     threads=1)
    with np.errstate(invalid="ignore"):
        want = _einsum_det(coords, conn, "qua").min(axis=1)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() >= 1 and bad == 0
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=1e-12, atol=0)


def test_shape_mismatch_raises():
    coords, conn = jittered_mesh("qua", n=2)
    with pytest.raises(ValueError, match="tet elements are 3D"):
        problem_mod._min_detj(coords, conn, element_lib.get("tet"), 1)
    with pytest.raises(ValueError, match="connectivity"):
        problem_mod._min_detj(coords, conn[:, :3], element_lib.get("qua"), 1)


def test_last_check_counts_elements_threads_and_bad():
    """`last_check` after `load` of a strip deck large enough for several
    threads, with one element planted inverted by a node swap."""
    from fem_tpu_torch.io import meshgen

    nx, ny = 256, 128
    problem = problem_mod.load(meshgen.quad_strip_deck(nx, ny))
    ne = nx * ny
    threads = kernels_build.host_threads(ne, problem_mod.ELEMENTS_PER_THREAD)
    assert threads == min(2, kernels_build.host_threads(ne, 1))
    assert problem_mod.last_check == dict(elements=ne, threads=threads,
                                          bad=0)
    blocks = problem.blocks
    blocks["qua"].conn[9] = blocks["qua"].conn[9, ::-1]
    assert len(recorded(problem_mod._validate_mesh, problem.coords,
                        blocks)) == 1
    assert problem_mod.last_check == dict(elements=ne, threads=threads,
                                          bad=1)
