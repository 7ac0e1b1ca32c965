"""fem_tpu_torch's halo block stencil (ops/blockstencil.py: shard_rows,
halo_matvec_g, the slab helpers) and the stepper row on it, on the CPU in
float64: against the single-device block stencil and against fem_tpu on its
8 virtual CPU devices, the same decks made from a seed with numpy. fem_tpu's
3D halo program takes over a minute to compile on the CPU, so the 3D lattice
is held against the port's own single-device form (itself held against
fem_tpu in tests/test_torch_unstructured.py) and fem_tpu's halo_matvec_g and
its stepper row are run on a 2D lattice."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import blockstencil as j_bs
from fem_tpu.parallel import make_mesh as j_make_mesh
from fem_tpu.solver import amg as j_amg
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import blockstencil as bs
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.solver import amg, stepper

torch.set_num_threads(1)


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def same_u(a, b, tol=1e-9):
    return (np.abs(a.aggregate_u - b.aggregate_u).max()
            <= tol * np.abs(b.aggregate_u).max())


def j_shard(mesh, blocks):
    return jax.device_put(blocks, NamedSharding(mesh, P(mesh.axis_names[0])))


def jittered_quads():
    """fem_tpu's 12 x 7 quad grid with its nodes moved by a seeded normal
    jitter: a 2D lattice (8 x 13 nodes) that is no uniform box."""
    jp = j_meshgen.quad_grid_problem(12, 7, E=100.0, nu=0.3,
                                     tip_force=(0.0, -1.0))
    rng = np.random.default_rng(7)
    return dataclasses.replace(
        jp, coords=jp.coords + 0.08 * rng.normal(size=jp.coords.shape) / 12)


# ---------------- block-stencil (variable-coefficient) halo ----------------


@pytest.fixture(scope="module")
def lattice():
    """fem_tpu's jittered 6^3 box of tests/test_halo.py (lattice topology,
    non-uniform geometry): its assembled block stencil."""
    s = System(meshgen.hex_box_problem(6, 6, 6, lx=1.0, ly=1.0, lz=1.0,
                                       E=70.0, nu=0.25, tip_load=-1.0,
                                       jitter=0.2), device="cpu")
    A = amg.assemble_csr(s)
    dims = bs.detect(A, 3, s.nnds)
    assert dims == (7, 7, 7)
    return bs.build(A, 3, dims, device="cpu")


def halo_apply(op, u_g, nd):
    """(K.u as a grid, the slabs of u) through shard_rows / halo_matvec_g
    over nd shards."""
    mesh = mesh_mod.make_mesh(nd, device="cpu")
    hop = bs.shard_rows(op, mesh)
    assert sum(v.shape[0] for v in hop.vals) == op.nnds
    u_b = mesh_mod.scatter(mesh, bs.u_to_slabs(u_g, nd))
    return bs.u_from_slabs(bs.halo_matvec_g(hop, u_b)), u_b, hop


@pytest.mark.parametrize("nd", [2, 3, 4, 8])
def test_blockstencil_halo_matvec_matches_local(lattice, nd):
    """halo_matvec_g (1e-12) against the single-device block stencil: 7
    node planes over 2, 3 and 4 shards are unequal slabs, over 8 the last
    slab is empty. The flat layout cuts the same slabs."""
    op = lattice
    u_g = torch.as_tensor(
        np.random.default_rng(0).standard_normal(op.dims + (3,)))
    out, u_b, hop = halo_apply(op, u_g, nd)
    ref = bs.matvec(op, u_g.reshape(-1))
    assert rel(out.reshape(-1), ref) < 1e-12
    assert [len(u) for u in u_b] == {2: [4, 3], 3: [3, 2, 2], 4: [2, 2, 2, 1],
                                     8: [1] * 7 + [0]}[nd]
    lay = hop.layout()
    parts = lay.scatter(ref).parts
    assert [tuple(p.shape) for p in parts] == [tuple(u.shape) for u in u_b]
    assert torch.equal(lay.gather(mesh_mod.ShardedVector(hop.mesh, parts)),
                       ref)


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_blockstencil_halo_matvec_matches_fem_tpu(nd):
    """halo_matvec_g (1e-12) against fem_tpu's on its pad_rows'd slabs, on
    the 2D lattice (8 node rows: equal slabs over 2 and 4 shards, padded to
    9 rows by fem_tpu and cut 3, 3, 2 here over 3)."""
    jp = jittered_quads()
    js = JSystem(jp)
    jA = j_amg.assemble_csr(js)
    jop = j_bs.build(jA, 2, j_bs.detect(jA, 2, js.ndof // 2))
    s = System(Problem.from_reference(jp), device="cpu")
    A = amg.assemble_csr(s)
    dims = bs.detect(A, 2, s.nnds)
    assert dims == jop.dims == (8, 13)
    op = bs.build(A, 2, dims, device="cpu")
    u_g = np.random.default_rng(0).standard_normal(dims + (2,))
    out, _, _ = halo_apply(op, torch.as_tensor(u_g), nd)

    jmesh = j_make_mesh(nd)
    jopp = j_bs.pad_rows(jop, nd)
    ju_p = j_bs.embed_rows_g(jnp.asarray(np.moveaxis(u_g, -1, 0)),
                             jopp.dims[0])
    ml, mr = (j_shard(jmesh, m) for m in j_bs.halo_masks(nd, ju_p.dtype))
    jout = j_bs.halo_matvec_g(
        jopp, j_shard(jmesh, j_bs.vals_to_slabs(jopp, nd)),
        j_shard(jmesh, j_bs.u_to_slabs(ju_p, nd)), jmesh, ml, mr)
    jout = np.moveaxis(np.asarray(j_bs.u_from_slabs(jout))[:, :dims[0]],
                       0, -1)
    assert rel(out, jout) < 1e-12


@pytest.mark.parametrize("kw,hier,shards", [
    (dict(), "smoothed aggregation", 4),
    (dict(gmg_min=1), "Geometric lattice-MG", 4),
    (dict(gmg_min=1), "Geometric lattice-MG", 8),
], ids=["sa_amg", "gmg", "gmg_8_shards"])
def test_stepper_halo_block_stencil_matches_single(kw, hier, shards):
    """Row sharded_halo_block_stencil on fem_tpu's jittered 5^3 box
    (tests/test_parallel.py:231-299) against the single-device lattice row:
    the same hierarchy, the same iterations, u to 1e-9. The vectors stay in
    slabs: no collective moves more than one node plane but the cycle's
    gather / scatter and the solve's entry and exit, and only scalars are
    all-reduced."""
    p = meshgen.hex_box_problem(5, 5, 5, jitter=0.25, t=1.0, dt=0.5)
    cfg = dict(device="cpu", solver="cg", precond="amg", **kw)
    ref = stepper.run(p, Config(**cfg))
    msgs, out = [], {}
    cols = commcount.collectives(lambda: out.update(r=stepper.run(
        p, Config(n_devices=shards, **cfg), log=msgs.append)))
    shd = out["r"]
    assert ref.path == "unstructured_amg_or_lattice_gmg_cg"
    assert shd.path == "sharded_halo_block_stencil"
    assert any("DOF-sharded halo block stencil" in m for m in msgs)
    assert any(hier in m for m in msgs)
    assert shd.krylov_iters == ref.krylov_iters
    assert same_u(shd, ref)
    plane = 6 * 6 * 3 * 8
    assert {c[2] for c in cols if c[0] == "neighbor_exchange"} == {plane}
    assert {c[2] for c in cols if c[0] == "all_reduce_sum"} == {8}
    assert not [c for c in cols if c[0] == "replicate"]


def test_stepper_halo_block_stencil_matches_fem_tpu():
    """One fem_tpu run of the tier, on the 2D lattice (its float32-inner
    refinement converges to the same tolerance): u to 1e-9, and the port's
    sharded run takes the single-device run's iterations."""
    jp = jittered_quads()
    jmsgs = []
    jr = j_stepper.run(jp, JConfig(solver="cg", precond="amg", n_devices=4),
                       log=jmsgs.append)
    assert any("DOF-sharded halo block stencil" in m for m in jmsgs)
    p = Problem.from_reference(jp)
    cfg = dict(device="cpu", solver="cg", precond="amg")
    r = stepper.run(p, Config(n_devices=4, **cfg))
    assert r.path == "sharded_halo_block_stencil"
    assert same_u(r, jr)
    assert r.krylov_iters == stepper.run(p, Config(**cfg)).krylov_iters


def test_gmg_demotion_on_the_sharded_row():
    """A GMG solve that hits its iteration cap demotes the sharded row to
    SA-AMG, as on the single-device row, and converges."""
    p = meshgen.hex_box_problem(5, 5, 5, jitter=0.25)
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg", precond="amg",
                              gmg_min=1, maxiter=5, n_devices=4),
                    log=msgs.append)
    assert any("SA-AMG demotion" in m for m in msgs)
    assert r.krylov_iters[0] < 5
    ref = stepper.run(p, Config(device="cpu", solver="direct"))
    assert same_u(r, ref, tol=1e-7)
