"""fem_tpu_torch's slab-sharded stencil (ops/structured.py: shard_slabs,
fields_to_blocks, matvec_sharded) and the stepper row on it, on the CPU in
float64: against the single-device forms and against fem_tpu on its 8
virtual CPU devices, the same inputs made from a seed with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu.parallel import make_mesh as j_make_mesh
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.ops import structured
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

LAM, MU = j_lame(70.0, 0.25)


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pair(shape, cells, fields_seed=None):
    """The same stencil operator from both packages; per-cell fields from a
    seed, else the scalar material."""
    lam, mu = np.asarray(LAM), np.asarray(MU)
    if fields_seed is not None:
        rng = np.random.default_rng(fields_seed)
        c = tuple(n - 1 for n in shape)
        lam, mu = rng.uniform(10.0, 90.0, c), rng.uniform(5.0, 40.0, c)
    jop = j_structured.build(cells, shape, jnp.asarray(lam), jnp.asarray(mu))
    op = structured.build(cells, shape, torch.as_tensor(lam),
                          torch.as_tensor(mu), device="cpu")
    return op, jop


@pytest.fixture(scope="module")
def cube():
    """fem_tpu's tests/test_halo.py grid: 8^3 cells, 4 shards."""
    op, jop = pair((9, 9, 9), (0.125,) * 3)
    return op, jop, mesh_mod.make_mesh(4, device="cpu"), j_make_mesh(4)


@pytest.mark.parametrize("fields", [None, 3], ids=["scalar", "fields"])
def test_matvec_sharded_matches_fem_tpu(cube, fields):
    """Slab-sharded K.u (tolerance 1e-12): the single-device K.u and
    fem_tpu's matvec_sharded on the same u; the per-cell fields cut into
    fem_tpu's cell slabs (fields_to_blocks)."""
    op, jop, mesh, jmesh = cube
    if fields is not None:
        op, jop = pair(op.shape, (0.125,) * 3, fields_seed=fields)
        for (lam_b, mu_b), jl, jm in zip(structured.fields_to_blocks(op, 4),
                                         *j_structured.fields_to_blocks(jop,
                                                                        4)):
            np.testing.assert_array_equal(lam_b.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(mu_b.numpy(), np.asarray(jm))
    else:
        assert structured.fields_to_blocks(op, 4) is None
    u = np.random.default_rng(0).normal(size=op.ndof)
    sl = structured.shard_slabs(op, mesh)
    got = structured.matvec_sharded(sl, torch.as_tensor(u))
    assert rel(got, structured.matvec(op, torch.as_tensor(u))) < 1e-12
    assert rel(got, j_structured.matvec_sharded(jop, jnp.asarray(u),
                                                jmesh)) < 1e-12
    # scalar material keeps the scalar on every slab (kernel K2's form)
    assert all((lop.tables is not None) == (fields is None)
               for lop in sl.ops)
    assert [lop.shape for lop in sl.ops] == [(3, 9, 9)] * 4


def test_unequal_slabs_and_more_shards_than_cells():
    """7 leading cells over 4 shards are slabs of 2, 2, 2 and 1 cells
    (fem_tpu pads to 8 with phantom cells); over 8 shards the last slab has
    no cell. matvec_sharded is exact on both (1e-12)."""
    op, _ = pair((8, 5, 5), (0.1, 0.2, 0.2))
    u = torch.as_tensor(np.random.default_rng(4).normal(size=op.ndof))
    ref = structured.matvec(op, u)
    sl4 = structured.shard_slabs(op, mesh_mod.make_mesh(4, device="cpu"))
    assert sl4.bounds == ((0, 2), (2, 4), (4, 6), (6, 7))
    assert rel(structured.matvec_sharded(sl4, u), ref) < 1e-12
    sl8 = structured.shard_slabs(op, mesh_mod.make_mesh(8, device="cpu"))
    assert sl8.bounds[-1] == (7, 7) and sl8.ops[-1].shape == (1, 5, 5)
    assert rel(structured.matvec_sharded(sl8, u), ref) < 1e-12


@pytest.mark.parametrize("kind,shards", [
    ("2d", 2), ("2d", 3), ("2d", 5), ("2d", 7), ("2d_fields", 6),
    ("3d", 2), ("3d", 5), ("3d_fields", 3),
], ids=lambda v: str(v))
def test_matvec_sharded_any_shard_count(kind, shards):
    """matvec_sharded equals the single-device K.u (1e-12) for any shard
    count, on slabs of the leading axis: y on the (ny, nx) node grid of a
    2D operator (11 cells, so no count divides it), x in 3D (7 cells). The
    slabs differ by at most one cell and cover every cell once; each
    scalar-material slab keeps the scalar (K2's tables), each field slab
    its own cells' fields."""
    shape, cells = (((12, 9), (0.1, 0.15)) if kind.startswith("2d") else
                    ((8, 5, 6), (0.1, 0.2, 0.15)))
    op, _ = pair(shape, cells,
                 fields_seed=7 if kind.endswith("fields") else None)
    sl = structured.shard_slabs(op, mesh_mod.make_mesh(shards, device="cpu"))
    sizes = [e - s for s, e in sl.bounds]
    assert sum(sizes) == shape[0] - 1 and max(sizes) - min(sizes) <= 1
    assert [lop.shape for lop in sl.ops] == [(c + 1,) + shape[1:]
                                             for c in sizes]
    if kind.endswith("fields"):
        for (s, e), lop in zip(sl.bounds, sl.ops):
            assert torch.equal(lop.lam, op.lam[s:e])
    else:
        assert all(lop.tables is not None for lop in sl.ops)
    u = torch.as_tensor(np.random.default_rng(shards).normal(size=op.ndof))
    assert rel(structured.matvec_sharded(sl, u),
               structured.matvec(op, u)) < 1e-12


# ---------------- the stepper rows ----------------


def same_u(a, b, tol=1e-9):
    return (np.abs(a.aggregate_u - b.aggregate_u).max()
            <= tol * np.abs(b.aggregate_u).max())


BOX = dict(lx=1.0, ly=1.0, lz=1.0, E=70.0, nu=0.25, tip_load=-1.0)


@pytest.mark.parametrize("dims,shards,line", [
    ((8, 4, 4), 4, "Stencil matvec sharded (slab + psum halo)"),
    ((6, 3, 3), 4, "6 cells in unequal slabs of [2, 2, 1, 1] over 4"),
    ((6, 3, 3), 8, "6 cells in unequal slabs of [1, 1, 1, 1, 1, 1, 0, 0]"),
], ids=["divisible", "not_divisible", "more_shards_than_cells"])
def test_stepper_slab_stencil_matches_single(dims, shards, line):
    """Row sharded_slab_stencil against the single-device structured row:
    the same MG-CG iterations, u to 1e-9; one all-reduce of the whole grid
    per K.u and no other traffic but its replicated input."""
    p = meshgen.hex_box_problem(*dims, **BOX)
    ref = stepper.run(p, Config(device="cpu", solver="cg", rtol=1e-12))
    msgs, out = [], {}
    cols = commcount.collectives(lambda: out.update(r=stepper.run(
        p, Config(device="cpu", solver="cg", rtol=1e-12, n_devices=shards),
        log=msgs.append)))
    shd = out["r"]
    assert (ref.path, shd.path) == ("structured_mg_cg",
                                    "sharded_slab_stencil")
    assert any(line in m for m in msgs), msgs
    assert any("MG fine level sharded over the slab mesh" in m for m in msgs)
    assert shd.krylov_iters == ref.krylov_iters
    assert same_u(shd, ref)
    ar = [c for c in cols if c[0] == "all_reduce_sum"]
    # CG's K.u, the right-hand side's, and the fine level's where the
    # hierarchy has more than one level
    assert len(ar) > sum(shd.krylov_iters)
    assert all(c[2] == p.ndof * 8 for c in ar)


def test_stepper_slab_stencil_matches_fem_tpu():
    """fem_tpu's padded run of tests/test_parallel.py:196-212 (6 cells over
    8 devices, zero-material phantom cells) and the port's unequal slabs:
    the same u (1e-9) and the same iteration counts; a 2D grid, divisible,
    with the fine level sharded in both (test_parallel.py:322-335)."""
    jp = j_meshgen.hex_box_problem(6, 3, 3, **BOX)
    jr = j_stepper.run(jp, JConfig(solver="cg", rtol=1e-12, n_devices=8))
    r = stepper.run(Problem.from_reference(jp), Config(
        device="cpu", solver="cg", rtol=1e-12, n_devices=8))
    assert same_u(r, jr)
    assert r.krylov_iters == [int(i) for i in jr.krylov_iters]
    jq = j_meshgen.quad_grid_problem(4, 8, E=100.0, nu=0.3,
                                     tip_force=(0.0, -1.0))
    jr = j_stepper.run(jq, JConfig(solver="cg", rtol=1e-12, n_devices=8))
    msgs = []
    r = stepper.run(Problem.from_reference(jq), Config(
        device="cpu", solver="cg", rtol=1e-12, n_devices=8), log=msgs.append)
    assert r.path == "sharded_slab_stencil"
    assert any("slab + psum halo" in m for m in msgs)
    assert same_u(r, jr)
    assert r.krylov_iters == [int(i) for i in jr.krylov_iters]
