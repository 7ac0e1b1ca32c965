"""fem_tpu_torch's DOF-sharded halo-gather operator
(parallel/halo_gather.py) and the stepper's tier on it, on the CPU in
float64, on the decks of fem_tpu's tests/test_halo_gather.py: the slab order,
S and B of `build` against fem_tpu's as numpy arrays, K.u against the
single-device fused operator (1e-12) and, on one deck, against fem_tpu's
matvec_cm_sharded on its 8 virtual CPU devices; the stepper row against the
single-device run and against one fem_tpu run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.parallel import halo_gather as j_hg
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import operator
from fem_tpu_torch.parallel import halo_gather as hg
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.solver import amg, cg, stepper

torch.set_num_threads(1)

DECKS = {
    "jittered_hex": lambda m: m.hex_box_problem(12, 6, 6, jitter=0.25,
                                                seed=3),
    "scrambled_numbering": lambda m: m.permute_nodes(
        m.hex_box_problem(24, 5, 5, jitter=0.2, seed=1), seed=7),
    "quads_2d": lambda m: m.quad_grid_problem(24, 12),
    "cohesive_elastic_block": lambda m: m.cohesive_interface_problem(
        48, 6, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015, t=1.0, dt=0.5,
        coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0)),
}


def apply(system, op, pos, u):
    """K.u of a deck-ordered u through the slab layout and back."""
    idx = torch.as_tensor(hg.dof_order(pos, system.pdim))
    lay = op.layout()
    us = lay.scatter(u[idx])
    out = lay.gather(mesh_mod.ShardedVector(op.mesh, hg.matvec(op, us.parts)))
    return torch.empty_like(out).index_copy_(0, idx, out)


@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("shards", [8, 3])
def test_halo_gather_matches_fused_operator(deck, shards):
    """build's pos, S and B are fem_tpu's; K.u equals the single-device
    fused operator's to 1e-12, also where the shards do not divide the
    nodes (the last slab is filled up with phantom nodes)."""
    jp = DECKS[deck](j_meshgen)
    jop, jpos = j_hg.build(JSystem(jp, dtype=jnp.float64), shards)
    s = System(Problem.from_reference(jp), device="cpu")
    op, pos = hg.build(s, mesh_mod.make_mesh(shards, device="cpu"))
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    assert (op.S, op.B, op.nnds, op.pdim) == (jop.S, jop.B, jop.nnds,
                                              jop.pdim)
    assert op.B < op.S  # banded, not degenerate
    assert sum(b.conn.shape[0] for b in op.blocks) == sum(
        b.conn.shape[0] for b in operator.build(s).blocks)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(s.ndof))
    want = operator.matvec(operator.build(s), u)
    got = apply(s, op, pos, u)
    assert float((got - want).norm()) < 1e-12 * float(want.norm())


def test_halo_gather_matches_fem_tpu_matvec():
    """The same K.u as fem_tpu's matvec_cm_sharded over 8 devices, slab by
    slab in the slab order (1e-12), on the 2D quads."""
    jp = DECKS["quads_2d"](j_meshgen)
    js = JSystem(jp, dtype=jnp.float64)
    jop, jpos = j_hg.build(js, 8)
    jmesh = Mesh(np.array(jax.devices()[:8]), ("shard",))
    u = np.random.default_rng(1).standard_normal(js.ndof)
    jup = j_hg.to_padded_cm(jnp.asarray(u), jpos, 8, jop.S, jop.pdim)
    jout = np.asarray(j_hg.matvec_cm_sharded(j_hg.device_put(jop, jmesh),
                                             jup, jmesh))  # (pdim, 8 S)
    s = System(Problem.from_reference(jp), device="cpu")
    op, pos = hg.build(s, mesh_mod.make_mesh(8, device="cpu"))
    idx = torch.as_tensor(hg.dof_order(pos, 2))
    us = op.layout().scatter(torch.as_tensor(u)[idx])
    np.testing.assert_array_equal(torch.cat(us.parts).numpy(),
                                  np.asarray(jup).T)
    out = torch.cat(hg.matvec(op, us.parts)).numpy()
    assert np.linalg.norm(out - jout.T) < 1e-12 * np.linalg.norm(jout)


def test_halo_gather_refusals():
    """fem_tpu's refusals, with its messages: a mesh whose elements reach
    past a whole slab (tiny cube over 8 slabs), and a multi-block mesh."""
    mesh = mesh_mod.make_mesh(8, device="cpu")
    s = System(meshgen.hex_box_problem(4, 4, 4), device="cpu")
    with pytest.raises(ValueError) as e:
        hg.build(s, mesh)
    with pytest.raises(ValueError) as je:
        j_hg.build(JSystem(j_meshgen.hex_box_problem(4, 4, 4),
                           dtype=jnp.float64), 8)
    assert str(e.value) == str(je.value)
    assert "exceeds slab size" in str(e.value)
    # two element types
    p = meshgen.quad_grid_problem(6, 4)
    blocks = dict(p.blocks)
    q = blocks.pop("qua")
    tri = np.concatenate([q.conn[:4, [0, 1, 2]], q.conn[:4, [0, 2, 3]]])
    blocks["qua"] = dataclasses.replace(
        q, conn=q.conn[4:], mat=q.mat[4:], nlmat=q.nlmat[4:],
        eids=q.eids[4:])
    blocks["tri"] = dataclasses.replace(
        q, eltype="tri", conn=tri.astype(np.int32), mat=np.zeros(8, np.int32),
        nlmat=np.full(8, -1, np.int32), eids=np.arange(8, dtype=np.int32))
    mixed = System(dataclasses.replace(p, blocks=blocks), device="cpu")
    with pytest.raises(ValueError, match="single-element-type meshes "
                                         r"\(got 2 blocks\)"):
        hg.build(mixed, mesh_mod.make_mesh(2, device="cpu"))


def test_sa_amg_cycle_on_slab_state_matches_flat():
    """The multi-level SA-AMG V-cycle on the slab-permuted matrix, its fine
    level on ShardedVectors over 4 shards (coarse_max below the stepper's,
    so that the hierarchy has transfer levels at this size): the same
    preconditioned vector (1e-12) and the same PCG iterates as with the
    permuted matrix's flat fine operator."""
    p = meshgen.permute_nodes(
        meshgen.hex_box_problem(12, 5, 5, jitter=0.25), seed=3)
    s = System(p, device="cpu")
    mesh = mesh_mod.make_mesh(4, device="cpu")
    op, pos = hg.build(s, mesh)
    idx = hg.dof_order(pos, 3)
    bc = s.bc_dofs.numpy()
    bc_p = pos[bc // 3] * 3 + bc % 3
    A_p = amg.assemble_csr(s)[idx][:, idx]
    hier = amg.build(s, bc_p, coarse_max=100, A=A_p,
                     coords=p.coords[np.argsort(pos)])
    assert len(hier.levels) >= 2
    K = torch.as_tensor(A_p.toarray())
    mask = torch.zeros(s.ndof, dtype=torch.bool)
    mask[torch.as_tensor(bc_p)] = True
    flat = cg.masked_operator(lambda v: K @ v, mask)
    lay = op.layout()
    shd = cg.masked_operator(
        lambda v: mesh_mod.ShardedVector(mesh, hg.matvec(op, v.parts)),
        lay.scatter(mask))
    r = torch.as_tensor(np.random.default_rng(2).normal(size=s.ndof))
    z_flat = amg.preconditioner(hier, flat)(r)
    pc = amg.preconditioner(hier, shd, lay)
    z = lay.gather(pc(lay.scatter(r)))
    assert float((z - z_flat).norm()) < 1e-12 * float(z_flat.norm())
    b = torch.where(mask, torch.zeros_like(r),
                    torch.as_tensor(s.rhs(0.0).numpy()[idx]))
    res_flat = cg.pcg(flat, b, precond=amg.preconditioner(hier, flat),
                      rtol=1e-9, maxiter=100)
    res = cg.pcg(shd, lay.scatter(b), precond=pc, rtol=1e-9, maxiter=100)
    assert res.iters == res_flat.iters < 60
    x = lay.gather(res.x)
    assert float((x - res_flat.x).norm()) < 1e-9 * float(res_flat.x.norm())


def test_stepper_halo_gather_general_topology():
    """fem_tpu's tests/test_parallel.py:354-378: a scrambled deck long
    enough for slab locality takes the halo-gather tier with SA-AMG on the
    slab-permuted operator. The aggregation order differs from the
    single-device hierarchy, so the iterations are held to fem_tpu's bar
    (total <= 2 x + 4) and the solution to 1e-9, against the single-device
    run and against fem_tpu's sharded run."""
    jp = j_meshgen.permute_nodes(
        j_meshgen.hex_box_problem(24, 5, 5, jitter=0.2, t=1.0, dt=1.0),
        seed=3)
    p = Problem.from_reference(jp)
    cfg = dict(device="cpu", solver="cg", precond="amg")
    ref = stepper.run(p, Config(**cfg))
    msgs = []
    shd = stepper.run(p, Config(n_devices=8, **cfg), log=msgs.append)
    assert shd.path == "sharded_amg_cg"
    assert any("DOF-sharded halo-gather operator (S=113, B=60)" in m
               for m in msgs), msgs
    assert any("slab-permuted operator" in m for m in msgs)
    assert sum(shd.krylov_iters) <= 2 * sum(ref.krylov_iters) + 4
    scale = np.abs(ref.aggregate_u).max()
    assert np.abs(shd.aggregate_u - ref.aggregate_u).max() <= 1e-9 * scale
    jr = j_stepper.run(jp, JConfig(solver="cg", precond="amg", n_devices=8))
    assert np.abs(shd.aggregate_u - jr.aggregate_u).max() <= 1e-9 * scale
