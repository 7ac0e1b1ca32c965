"""fem_tpu_torch's slab-sharded stencil (ops/structured.py: matvec_sharded,
the block layout and halo_matvec, pad_for_devices) and the stepper row on
it, on the CPU in float64: against the single-device forms and against
fem_tpu on its 8 virtual CPU devices, the same inputs made from a seed with
numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

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


def j_shard(mesh, blocks):
    return jax.device_put(blocks, NamedSharding(mesh, P(mesh.axis_names[0])))


@pytest.fixture(scope="module")
def cube():
    """fem_tpu's tests/test_halo.py grid: 8^3 cells, 4 shards."""
    op, jop = pair((9, 9, 9), (0.125,) * 3)
    return op, jop, mesh_mod.make_mesh(4, device="cpu"), j_make_mesh(4)


@pytest.mark.parametrize("fields", [None, 3], ids=["scalar", "fields"])
def test_matvec_sharded_matches_fem_tpu(cube, fields):
    """Slab-sharded K.u (tolerance 1e-12): the single-device K.u and
    fem_tpu's matvec_sharded on the same u."""
    op, jop, mesh, jmesh = cube
    if fields is not None:
        op, jop = pair(op.shape, (0.125,) * 3, fields_seed=fields)
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


@pytest.mark.parametrize("fields", [None, 3], ids=["scalar", "fields"])
def test_halo_matvec_matches_fem_tpu(cube, fields):
    """K.u on the overlapping block layout (1e-12), block by block against
    fem_tpu's halo_matvec (its field_blocks from fields_to_blocks);
    duplicated planes stay consistent."""
    op, jop, mesh, jmesh = cube
    jfb = None
    if fields is not None:
        op, jop = pair(op.shape, (0.125,) * 3, fields_seed=fields)
        jfb = tuple(j_shard(jmesh, f)
                    for f in j_structured.fields_to_blocks(jop, 4))
        for (lam_b, mu_b), jl, jm in zip(structured.fields_to_blocks(op, 4),
                                         *jfb):
            np.testing.assert_array_equal(lam_b.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(mu_b.numpy(), np.asarray(jm))
    else:
        assert structured.fields_to_blocks(op, 4) is None
    u = np.random.default_rng(1).normal(size=op.ndof)
    sl = structured.shard_slabs(op, mesh)
    ub = mesh_mod.scatter(mesh, structured.to_blocks(sl, torch.as_tensor(u)))
    fb = structured.halo_matvec(sl, ub)
    assert rel(structured.from_blocks(sl, fb),
               structured.matvec(op, torch.as_tensor(u))) < 1e-12
    jub = j_structured.to_blocks(jop, jnp.asarray(u), 4)
    np.testing.assert_array_equal(torch.stack(ub).numpy(), np.asarray(jub))
    jfbk = j_structured.halo_matvec(jop, j_shard(jmesh, jub), jmesh,
                                    field_blocks=jfb)
    assert rel(torch.stack(fb), jfbk) < 1e-12
    for d in range(1, 4):
        assert torch.equal(fb[d][0], fb[d - 1][-1])


def test_block_round_trip_and_weighted_dot(cube):
    """from_blocks inverts to_blocks; the weighted dot on blocks is the
    plain dot (1e-12); the weights are fem_tpu's."""
    op, jop, mesh, _ = cube
    rng = np.random.default_rng(2)
    u, v = (torch.as_tensor(rng.normal(size=op.ndof)) for _ in range(2))
    sl = structured.shard_slabs(op, mesh)
    ub, vb = structured.to_blocks(sl, u), structured.to_blocks(sl, v)
    assert torch.equal(structured.from_blocks(sl, ub), u)
    w = structured.block_weights(sl, u.dtype)
    np.testing.assert_array_equal(
        torch.stack(w).numpy(),
        np.asarray(j_structured.block_weights(jop, 4, jnp.float64)))
    dot = sum(float((wi * a * b).sum()) for wi, a, b in zip(w, ub, vb))
    assert abs(dot - float(u @ v)) <= 1e-12 * abs(float(u @ v))


def test_unequal_slabs_and_more_shards_than_cells():
    """7 leading cells over 4 shards are slabs of 2, 2, 2 and 1 cells
    (fem_tpu pads to 8 with phantom cells); over 8 shards the last slab has
    no cell. matvec_sharded is exact on both (1e-12); the block layout needs
    a cell in every slab."""
    op, _ = pair((8, 5, 5), (0.1, 0.2, 0.2))
    u = torch.as_tensor(np.random.default_rng(4).normal(size=op.ndof))
    ref = structured.matvec(op, u)
    sl4 = structured.shard_slabs(op, mesh_mod.make_mesh(4, device="cpu"))
    assert sl4.bounds == ((0, 2), (2, 4), (4, 6), (6, 7))
    assert rel(structured.matvec_sharded(sl4, u), ref) < 1e-12
    fb = structured.halo_matvec(sl4, structured.to_blocks(sl4, u))
    assert rel(structured.from_blocks(sl4, fb), ref) < 1e-12
    sl8 = structured.shard_slabs(op, mesh_mod.make_mesh(8, device="cpu"))
    assert sl8.bounds[-1] == (7, 7) and sl8.ops[-1].shape == (1, 5, 5)
    assert rel(structured.matvec_sharded(sl8, u), ref) < 1e-12
    with pytest.raises(ValueError, match="a cell in every slab"):
        structured.halo_matvec(sl8, structured.to_blocks(sl8, u))


def test_pad_for_devices_matches_fem_tpu():
    """fem_tpu's tests/test_halo.py:145-170: the padded operator is
    fem_tpu's (shape and fields), its K.u on embedded vectors is the
    unpadded K.u (1e-12), sharded or not; a no-op when divisible."""
    shape, cells = (8, 5, 5), (0.1, 0.2, 0.2)
    op, jop = pair(shape, cells)
    op_p, embed, extract = structured.pad_for_devices(op, 4)
    jop_p, jembed, jextract = j_structured.pad_for_devices(jop, 4)
    assert op_p.shape == jop_p.shape == (9, 5, 5)
    for got, want in ((op_p.lam, jop_p.lam), (op_p.mu, jop_p.mu)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = np.random.default_rng(4).normal(size=op.ndof)
    tu = torch.as_tensor(u)
    np.testing.assert_array_equal(embed(tu).numpy(),
                                  np.asarray(jembed(jnp.asarray(u))))
    assert torch.equal(extract(embed(tu)), tu)
    ref = structured.matvec(op, tu)
    assert rel(extract(structured.matvec(op_p, embed(tu))), ref) < 1e-12
    sl = structured.shard_slabs(op_p, mesh_mod.make_mesh(4, device="cpu"))
    assert [e - s for s, e in sl.bounds] == [2, 2, 2, 2]
    got = extract(structured.matvec_sharded(sl, embed(tu)))
    assert rel(got, ref) < 1e-12
    assert rel(got, jextract(j_structured.matvec_sharded(
        jop_p, jembed(jnp.asarray(u)), j_make_mesh(4)))) < 1e-12
    # per-cell fields pad with zero cells as well
    opf, jopf = pair(shape, cells, fields_seed=5)
    np.testing.assert_array_equal(
        structured.pad_for_devices(opf, 4)[0].lam.numpy(),
        np.asarray(j_structured.pad_for_devices(jopf, 4)[0].lam))
    op9, _ = pair((9, 4, 4), cells)
    assert structured.pad_for_devices(op9, 4)[0] is op9


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
