"""The communication model of the element-sharded operator, counted.

fem_tpu validates its per-apply traffic model (DESIGN.md §5b) by counting
the collectives in its traced programs (tests/test_comm_model.py); the port
counts the calls of its two collectives (parallel/mesh.py) through
parallel/commcount.py. Element-sharded K.u: ONE full-vector all-reduce,
ndof * itemsize operand bytes, whatever the number of shards."""

import numpy as np
import pytest
import torch

from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.system import System
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.parallel.mesh import make_mesh
from fem_tpu_torch.parallel.ops import ShardedOperator, solve_step_sharded

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    return System(meshgen.quad_grid_problem(12, 7, E=100.0, nu=0.3,
                                            tip_force=(0.0, -1.0)),
                  device="cpu")


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
