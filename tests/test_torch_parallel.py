"""fem_tpu_torch's element-sharded tier (parallel/mesh.py, parallel/ops.py,
the stepper's sharded rows, `--devices`) on the CPU in float64: the sharded
operator against the single-device one and against fem_tpu's ShardedOperator
on its 8 virtual CPU devices, and sharded runs against single-device runs of
the same deck. The DOF-sharded tiers have their own files
(tests/test_torch_halo.py, test_torch_halo_block.py,
test_torch_halo_gather.py); here every sharded row is run through the path
table."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.parallel import ShardedOperator as JShardedOperator
from fem_tpu.parallel import make_mesh as j_make_mesh
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen, vtk
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import structured
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.parallel.mesh import make_mesh
from fem_tpu_torch.parallel.ops import ShardedOperator, solve_step_sharded
from fem_tpu_torch.solver import amg, cg, stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC_DECK = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic",
                            "elastic_test.inp")


def close(got, ref, rtol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def grid():
    """fem_tpu's 12 x 7 quad grid (208 DOFs) as (fem_tpu Problem, its
    ShardedOperator over 8 virtual CPU devices, the port's System)."""
    jp = j_meshgen.quad_grid_problem(12, 7, E=100.0, nu=0.3,
                                     tip_force=(0.0, -1.0))
    return (jp, JShardedOperator(JSystem(jp), j_make_mesh(8)),
            System(Problem.from_reference(jp), device="cpu"))


def test_make_mesh_on_the_cpu():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.cards == (torch.device("cpu"),)
    assert mesh.describe() == "8 shards on 1 CPU device"
    assert make_mesh(device="cpu").size == 1


@pytest.mark.parametrize("shards", [8, 4])
def test_sharded_matvec_matches_local(grid, shards):
    _, jop, system = grid
    op = ShardedOperator(system, make_mesh(shards, device="cpu"))
    u = np.random.default_rng(0).normal(size=system.ndof)
    got = op.matvec(torch.as_tensor(u))
    close(got, system.matvec(torch.as_tensor(u)), rtol=1e-12)
    close(got, jop.matvec(jnp.asarray(u)), rtol=1e-12)


@pytest.mark.parametrize("shards", [8, 4])
def test_sharded_diag_matches_local(grid, shards):
    _, jop, system = grid
    op = ShardedOperator(system, make_mesh(shards, device="cpu"))
    close(op.diag(), system.diag(), rtol=1e-12)
    close(op.diag(), jop.diag(), rtol=1e-12)


def test_uneven_padding():
    """5 elements over 4 shards: shares of 1, 1, 1 and 2 elements (fem_tpu
    pads to 8 with zero elements) give the same product."""
    jp = j_meshgen.quad_grid_problem(5, 1, E=10.0, nu=0.2)
    system = System(Problem.from_reference(jp), device="cpu")
    op = ShardedOperator(system, make_mesh(4, device="cpu"))
    assert [int(s.blocks[0].conn.shape[0]) for s in op.shards] == [1, 1, 1, 2]
    u = np.random.default_rng(1).normal(size=system.ndof)
    got = op.matvec(torch.as_tensor(u))
    close(got, system.matvec(torch.as_tensor(u)), rtol=1e-12)
    jop = JShardedOperator(JSystem(jp), j_make_mesh(4))
    close(got, jop.matvec(jnp.asarray(u)), rtol=1e-12)
    close(op.diag(), system.diag(), rtol=1e-12)
    # more shards than elements: empty shares
    op7 = ShardedOperator(system, make_mesh(7, device="cpu"))
    close(op7.matvec(torch.as_tensor(u)), got, rtol=1e-12)


def test_sharded_operator_ke_mode(grid):
    """The stored-k_e sharding mode (against the default fused mode)."""
    jp, _, system = grid
    op = ShardedOperator(system, make_mesh(4, device="cpu"), mode="ke")
    u = np.random.default_rng(5).normal(size=system.ndof)
    got = op.matvec(torch.as_tensor(u))
    close(got, system.matvec(torch.as_tensor(u)), rtol=1e-12)
    close(op.diag(), system.diag(), rtol=1e-12)
    jop = JShardedOperator(JSystem(jp), j_make_mesh(4), mode="ke")
    close(got, jop.matvec(jnp.asarray(u)), rtol=1e-12)
    close(op.diag(), jop.diag(), rtol=1e-12)
    with pytest.raises(ValueError, match="mode"):
        ShardedOperator(system, make_mesh(2, device="cpu"), mode="csr")


def test_sharded_solve_matches_direct(grid):
    jp, _, system = grid
    op = ShardedOperator(system, make_mesh(8, device="cpu"))
    du, stress, iters = solve_step_sharded(system, op, 0.0, rtol=1e-12)
    ref = stepper.run(Problem.from_reference(jp),
                      Config(device="cpu", solver="direct"))
    assert np.abs(du.numpy() - ref.du).max() <= 1e-9 * np.abs(ref.du).max()
    assert (np.abs(stress.numpy() - ref.aggregate_stress).max()
            <= 1e-8 * np.abs(ref.aggregate_stress).max())
    assert iters > 0


def same_run(shd, ref, u_tol=1e-9, stress_tol=1e-8):
    assert (np.abs(shd.aggregate_u - ref.aggregate_u).max()
            <= u_tol * np.abs(ref.aggregate_u).max())
    assert (np.abs(shd.aggregate_stress - ref.aggregate_stress).max()
            <= stress_tol * np.abs(ref.aggregate_stress).max())


@pytest.mark.parametrize("shards", [8, 4])
def test_stepper_devices_unstructured_matches_single(grid, shards):
    """Config(n_devices=...) on a non-box mesh takes the element-sharded
    Jacobi row and matches the single-device run, iteration for iteration."""
    jp, _, _ = grid
    rng = np.random.default_rng(7)
    coords = jp.coords + 0.08 * rng.normal(size=jp.coords.shape) / 12
    p = dataclasses.replace(Problem.from_reference(jp), coords=coords)
    assert structured.detect(p) is None
    ref = stepper.run(p, Config(device="cpu", solver="cg", rtol=1e-12))
    msgs = []
    shd = stepper.run(p, Config(device="cpu", solver="cg", rtol=1e-12,
                                n_devices=shards), log=msgs.append)
    assert ref.path == "unstructured_jacobi_cg"
    assert shd.path == "sharded_jacobi_cg"
    assert any(f"{shards} shards on 1 CPU device" in m for m in msgs)
    same_run(shd, ref)
    assert shd.krylov_iters == ref.krylov_iters


def test_stepper_devices_amg_permuted_element_sharded():
    """A deck with no slab locality (fem_tpu's tiny scrambled cube: over 8
    slabs an element reaches farther than a slab, so the halo-gather layout
    refuses) falls back to the element-sharded AMG tier: fine-level matvecs
    all-reduce over the mesh, coarse levels on shard 0; same iteration
    counts, same answer."""
    p = meshgen.permute_nodes(
        meshgen.hex_box_problem(5, 5, 5, jitter=0.25, t=1.0, dt=0.5), seed=3)
    ref = stepper.run(p, Config(device="cpu", solver="cg", precond="amg"))
    msgs, out = [], {}
    cols = commcount.collectives(lambda: out.update(r=stepper.run(
        p, Config(device="cpu", solver="cg", precond="amg", n_devices=8),
        log=msgs.append)))
    shd = out["r"]
    assert ref.path == "unstructured_amg_or_lattice_gmg_cg"
    assert shd.path == "sharded_amg_cg"
    assert any("sharded operator" in m for m in msgs)
    assert any("(halo-gather layout unavailable: element reach B=53 "
               "exceeds slab size S=27" in m for m in msgs)
    assert any("element-sharded tier" in m for m in msgs)
    assert shd.krylov_iters == ref.krylov_iters
    same_run(shd, ref)
    assert sum(c[0] == "all_reduce_sum" for c in cols) > 0


def test_sharded_amg_cycle_matches_single():
    """The multi-level SA-AMG V-cycle around the sharded fine operator
    (coarse_max below the stepper's, so that the hierarchy has transfer
    levels at this size): the same preconditioned vector and the same PCG
    iterates as around the single-device fused operator."""
    from fem_tpu_torch.ops import operator

    p = meshgen.permute_nodes(
        meshgen.hex_box_problem(6, 6, 6, jitter=0.25), seed=3)
    system = System(p, device="cpu")
    hier = amg.build(system, system.bc_dofs, coarse_max=100)
    assert len(hier.levels) >= 2
    mask = torch.zeros(system.ndof, dtype=torch.bool)
    mask[system.bc_dofs] = True
    fop = operator.build(system)
    sop = ShardedOperator(system, make_mesh(4, device="cpu"))
    one = cg.masked_operator(lambda v: operator.matvec(fop, v), mask)
    shd = cg.masked_operator(sop.matvec, mask)
    r = torch.as_tensor(np.random.default_rng(2).normal(size=system.ndof))
    close(amg.v_cycle(hier, shd, r), amg.v_cycle(hier, one, r), rtol=1e-12)
    b = cg.constrained_rhs(sop.matvec, system.rhs(0.0), mask,
                           torch.zeros(system.ndof, dtype=torch.float64))
    res = [cg.pcg(mv, b, precond=amg.preconditioner(hier, mv), rtol=1e-9,
                  maxiter=100) for mv in (one, shd)]
    assert res[0].iters == res[1].iters < 60
    close(res[1].x, res[0].x, rtol=1e-9)


@pytest.mark.parametrize("kw,kind", [(dict(amg_threshold=1), "hierarchy"),
                                     (dict(), "jacobi")])
def test_stepper_devices_cohesive_matches_single(kw, kind):
    """n_devices on a cohesive deck shards the Newton path's elastic
    products: identical Newton and inner iteration counts, same u."""
    p = meshgen.cohesive_interface_problem(4, 2, open_disp=0.004, t=1.0,
                                           dt=0.5)
    ref = stepper.run(p, Config(device="cpu", solver="cg", **kw))
    msgs, out = [], {}
    cols = commcount.collectives(lambda: out.update(r=stepper.run(
        p, Config(device="cpu", solver="cg", n_devices=4, **kw),
        log=msgs.append)))
    shd = out["r"]
    assert shd.path == ref.path == "cohesive_newton"
    assert any("Nonlinear path" in m for m in msgs)
    assert any("element-sharded" in m for m in msgs) == (kind == "hierarchy")
    assert shd.newton_iters == ref.newton_iters
    assert shd.krylov_iters == ref.krylov_iters
    assert all(shd.newton_converged)
    same_run(shd, ref, u_tol=1e-8)
    assert (sum(c[0] == "all_reduce_sum" for c in cols)
            > sum(shd.krylov_iters))


@pytest.mark.parametrize("kw", [dict(solver="direct"),
                                dict(solver="direct", formulation="total")],
                         ids=["direct", "total"])
def test_devices_ignored_by_dense_and_explicit_runs(kw):
    """Direct solves, formulation "total" and explicit runs ignore the
    mesh, as in fem_tpu: the same path, no collective."""
    p = meshgen.cohesive_interface_problem(4, 2, open_disp=0.004, t=1.0,
                                           dt=0.5)
    box = meshgen.hex_box_problem(2, 2, 2, jitter=0.3)
    ebox = dataclasses.replace(box, stype="explicit")
    paths = []

    def runs():
        for prob, cfg in ((p, kw), (box, dict(solver="direct")), (ebox, {})):
            paths.append(stepper.run(
                prob, Config(device="cpu", n_devices=4, **cfg)).path)

    assert commcount.collectives(runs) == []
    assert paths == ["cohesive_newton", "direct", "explicit"]


def test_cli_devices_flag(tmp_path):
    """`python -m fem_tpu_torch -f deck --devices 8` solves sharded end to
    end and still matches the elastic golden deck."""
    rc = cli_main(["-f", ELASTIC_DECK, "--device", "cpu", "--devices", "8",
                   "--solver", "cg", "-o", str(tmp_path) + "/", "-q"])
    assert rc == 0
    pts, stress, disp = vtk.read_fields(str(tmp_path / "0_output_000000.vtk"))
    np.testing.assert_allclose(sorted(disp[:, 1]),
                               [0, 0, 0.05, 0.05, 0.1, 0.1], atol=1e-6)
    np.testing.assert_allclose(stress[:, :2], [[105.0, 245.0]] * 6, atol=1e-4)


@pytest.mark.parametrize("problem,tier", [
    (lambda: meshgen.hex_box_problem(6, 3, 3, lx=1.0, ly=1.0, lz=1.0),
     "sharded_slab_stencil"),
    (lambda: meshgen.hex_box_problem(5, 5, 5, jitter=0.25),
     "sharded_halo_block_stencil"),
], ids=["structured_box", "lex_lattice_amg"])
def test_dof_sharded_tiers_raise_from_the_path_table(problem, tier):
    """The DOF-sharded tiers, which used to raise from stepper.PATHS, run
    from it: the same decks, 2 shards, the row's name, the single-device
    run's iterations and u (1e-9), and their own traffic (the slab row
    all-reduces whole grids, the halo row only scalars)."""
    assert tier in [name for name, _ in stepper.PATHS]
    cfg = dict(device="cpu", solver="cg", precond="amg")
    out = {}
    cols = commcount.collectives(lambda: out.update(r=stepper.run(
        problem(), Config(n_devices=2, **cfg))))
    shd, ref = out["r"], stepper.run(problem(), Config(**cfg))
    assert shd.path == tier and ref.path != tier
    assert shd.krylov_iters == ref.krylov_iters
    same_run(shd, ref)
    sizes = {c[2] for c in cols if c[0] == "all_reduce_sum"}
    assert sizes == ({ref.aggregate_u.size * 8}
                     if tier == "sharded_slab_stencil" else {8})


def test_make_mesh_too_few_devices(monkeypatch):
    """fem_tpu's message when more shards are asked for than CUDA cards
    exist; FEM_TPU_TORCH_VIRTUAL_DEVICES lays shards round-robin over the
    cards there are."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv(mesh_mod.VIRTUAL_ENV, raising=False)
    with pytest.raises(ValueError,
                       match="requested 3 devices, only 2 available"):
        make_mesh(3)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))
    monkeypatch.setenv(mesh_mod.VIRTUAL_ENV, "4")
    mesh = make_mesh(4)
    assert [d.index for d in mesh.devices] == [0, 1, 0, 1]
    assert mesh.describe() == "4 shards on 2 card(s)"
    with pytest.raises(ValueError,
                       match="requested 5 devices, only 4 available"):
        make_mesh(5)


@pytest.mark.cuda
def test_make_mesh_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    os.environ.pop(mesh_mod.VIRTUAL_ENV, None)
    with pytest.raises(ValueError, match=f"requested {n + 1} devices, only "
                                         f"{n} available"):
        make_mesh(n + 1)
    assert make_mesh().size == n
