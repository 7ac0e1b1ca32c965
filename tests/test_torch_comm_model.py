"""The communication model of the sharded operators, counted.

fem_tpu validates its per-apply traffic model (DESIGN.md §5b) by counting
the collectives in its traced programs (tests/test_comm_model.py); the port
counts the calls of its collectives (parallel/mesh.py) through
parallel/commcount.py, on pre-sharded input. With n cells a side, p = pdim,
w = itemsize:
  plane_bytes = (n + 1)^2 p w                       (one boundary node plane)
  block-stencil halo (blockstencil.halo_matvec_g):  2 plane_bytes per K.u
  halo-gather        (halo_gather.matvec):          4 B p w per K.u
  slab stencil, u replicated (matvec_sharded) and the element-sharded
  operator: ONE full-vector all-reduce, ndof w operand bytes, whatever the
  number of shards."""

import numpy as np
import pytest
import torch

from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import blockstencil as bs
from fem_tpu_torch.ops import structured
from fem_tpu_torch.ops.stiffness import lame
from fem_tpu_torch.parallel import commcount, halo_gather
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.parallel.mesh import make_mesh
from fem_tpu_torch.parallel.ops import ShardedOperator, solve_step_sharded
from fem_tpu_torch.solver import amg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    return System(meshgen.quad_grid_problem(12, 7, E=100.0, nu=0.3,
                                            tip_force=(0.0, -1.0)),
                  device="cpu")


def names(cols):
    return [c[0] for c in cols]


@pytest.mark.parametrize("fields", [False, True], ids=["scalar", "fields"])
def test_slab_stencil_halo_two_planes(fields):
    """fem_tpu's test_slab_stencil_halo_two_planes, 8^3 cells over 4
    shards, on the port's one slab form (fem_tpu's halo block layout is not
    carried): u replicated, one all-reduce of the whole grid per K.u."""
    n, nd = 8, 4
    lam, mu = lame(torch.tensor(70.0, dtype=torch.float64),
                   torch.tensor(0.25, dtype=torch.float64))
    if fields:
        lam, mu = lam * torch.ones((n,) * 3), mu * torch.ones((n,) * 3)
    op = structured.build((1.0 / n,) * 3, (n + 1,) * 3, lam, mu,
                          device="cpu")
    mesh = make_mesh(nd, device="cpu")
    sl = structured.shard_slabs(op, mesh)
    u = torch.ones(op.ndof, dtype=torch.float64)
    cols = commcount.collectives(structured.matvec_sharded, sl, u)
    assert sorted(cols) == [("all_reduce_sum", (op.ndof,), op.ndof * 8),
                            ("replicate", (op.ndof,), op.ndof * 8)]


@pytest.mark.parametrize("nd", [4, 3])
def test_blockstencil_halo_two_planes(nd):
    """fem_tpu's test_blockstencil_halo_two_planes: the jittered 6^3 box;
    7 node planes over 4 and over 3 shards, the same two planes."""
    n = 6
    s = System(meshgen.hex_box_problem(n, n, n, jitter=0.2), device="cpu")
    A = amg.assemble_csr(s)
    op = bs.build(A, s.pdim, bs.detect(A, s.pdim, s.nnds), device="cpu")
    mesh = make_mesh(nd, device="cpu")
    hop = bs.shard_rows(op, mesh)
    u_b = hop.layout().scatter(torch.ones(s.ndof, dtype=torch.float64))
    cols = commcount.collectives(bs.halo_matvec_g, hop, u_b.parts)
    plane_bytes = (n + 1) ** 2 * op.pdim * 8
    assert cols == [("neighbor_exchange", (1, n + 1, n + 1, 3),
                     plane_bytes)] * 2


def test_halo_gather_four_bands():
    """fem_tpu's test_halo_gather_four_bands: four (B, pdim) bands, no
    all-reduce."""
    nd = 8
    s = System(meshgen.hex_box_problem(12, 6, 6, jitter=0.25, seed=3),
               device="cpu")
    op, pos = halo_gather.build(s, make_mesh(nd, device="cpu"))
    up = op.layout().scatter(torch.ones(s.ndof, dtype=torch.float64))
    cols = commcount.collectives(halo_gather.matvec, op, up.parts)
    band_bytes = op.B * op.pdim * 8
    assert cols == [("neighbor_exchange", (op.B, op.pdim), band_bytes)] * 4
    assert 4 * band_bytes < s.ndof * 8


def test_sharded_vector_dot_is_one_scalar_all_reduce():
    """The DOF-sharded CG's only traffic beside its K.u: one scalar
    all-reduce per dot product or norm; the updates are local."""
    mesh = make_mesh(3, device="cpu")
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.normal(size=10)) for _ in range(2))
    lay = mesh_mod.SlabLayout(mesh, lambda v: list(v.split([4, 3, 3])),
                              torch.cat)
    va, vb = lay.scatter(a), lay.scatter(b)
    out = {}
    cols = commcount.collectives(lambda: out.update(
        dot=va.dot(vb), norm=va.norm(), axpy=va + 2.0 * vb - va * vb / 3.0))
    assert cols == [("all_reduce_sum", (), 8)] * 2
    assert abs(float(out["dot"]) - float(a @ b)) < 1e-14
    assert abs(float(out["norm"]) - float(a.norm())) < 1e-14
    assert torch.allclose(lay.gather(out["axpy"]), a + 2.0 * b - a * b / 3.0,
                          rtol=1e-15, atol=0)
    assert names(commcount.collectives(lay.gather, va)) == ["gather"]
    assert commcount.collectives(lay.scatter, a) == [("scatter", (10,), 80)]


@pytest.mark.parametrize("mode", ["fused", "ke"])
@pytest.mark.parametrize("shards", [8, 3])
def test_element_dp_one_full_psum(system, mode, shards):
    op = ShardedOperator(system, make_mesh(shards, device="cpu"), mode=mode)
    u = torch.ones(system.ndof, dtype=torch.float64)
    cols = commcount.collectives(op.matvec, u)
    ps = [c for c in cols if c[0] == "all_reduce_sum"]
    assert len(ps) == 1, cols
    # the operand is the FULL dof vector: the O(ndof) collective the halo
    # layouts exist to avoid
    assert ps[0][1] == (system.ndof,)
    assert ps[0][2] == system.ndof * u.element_size()
    # the replicated input is the only other traffic
    assert [c[0] for c in cols if c[0] != "all_reduce_sum"] == ["replicate"]
    assert [c[0] for c in commcount.collectives(op.diag)] == [
        "all_reduce_sum"]
    # nothing is recorded once collectives() has returned
    op.matvec(u)
    assert len(cols) == 2


def test_float32_operand_bytes():
    s32 = System(meshgen.quad_grid_problem(5, 2), torch.float32,
                 device="cpu")
    op = ShardedOperator(s32, make_mesh(2, device="cpu"))
    cols = commcount.collectives(op.matvec, torch.ones(s32.ndof))
    assert [c for c in cols if c[0] == "all_reduce_sum"] == [
        ("all_reduce_sum", (s32.ndof,), s32.ndof * 4)]


def test_jacobi_pcg_solve_counts(system):
    """Over a whole Jacobi-PCG solve: one all-reduce per CG iteration plus
    the set-up applies (the BC lift K ubc of the right-hand side; a cold
    start computes no first residual)."""
    op = ShardedOperator(system, make_mesh(4, device="cpu"))
    d = op.diag()
    out = {}

    def solve():
        out["iters"] = solve_step_sharded(system, _WithDiag(op, d), 0.0,
                                          rtol=1e-10)[2]

    cols = commcount.collectives(solve)
    n_ar = sum(c[0] == "all_reduce_sum" for c in cols)
    assert out["iters"] > 10
    assert n_ar == out["iters"] + 1
    assert all(c[2] == system.ndof * 8 for c in cols)

    # warm-started, one more: the first residual b - A x0
    def warm():
        out["iters"] = solve_step_sharded(
            system, _WithDiag(op, d), 0.0, rtol=1e-10,
            du0=torch.zeros(system.ndof, dtype=torch.float64))[2]

    cols = commcount.collectives(warm)
    assert (sum(c[0] == "all_reduce_sum" for c in cols)
            == out["iters"] + 2)


class _WithDiag:
    """The operator with its diagonal already formed, so that the solve's
    count holds K.u applies only."""

    def __init__(self, op, d):
        self.matvec = op.matvec
        self.diag = lambda: d


def test_summary_line(system):
    op = ShardedOperator(system, make_mesh(2, device="cpu"))
    u = torch.ones(system.ndof, dtype=torch.float64)
    n = system.ndof * 8
    assert commcount.summary("element-DP K.u",
                             commcount.collectives(op.matvec, u)) == (
        f"[comm] element-DP K.u: all_reduce_sum x1 ({n} B), "
        f"replicate x1 ({n} B)")
    assert commcount.summary("none", []) == "[comm] none: no collectives"
    assert np.isfinite(op.matvec(u).numpy()).all()
