"""fem_tpu_torch's mixed-precision iterative refinement (solver/mixed.py)
against fem_tpu's `mixed.ir_solve` on the CPU: the same float64 answer from
float32 inner solves, with equal outer and inner counts (+-1)."""

import jax.numpy as jnp
import numpy as np
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import operator as j_operator
from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu.solver import mixed as j_mixed
from fem_tpu.solver import multigrid as j_mg
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import operator, structured
from fem_tpu_torch.ops.stiffness import lame
from fem_tpu_torch.solver import cg, mixed, multigrid

torch.set_num_threads(1)


def box(n):
    jp = j_meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                   E=200e9, nu=0.3, tip_load=-1e6)
    return jp, JSystem(jp, dtype=jnp.float64), System(
        Problem.from_reference(jp), torch.float64, device="cpu")


def same(res, jres, tol):
    assert abs(res.outer_iters - int(jres.outer_iters)) <= 1
    assert abs(res.inner_iters - int(jres.inner_iters)) <= max(
        1, int(jres.outer_iters))  # +-1 in each inner solve
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert x.dtype == np.float64
    assert np.abs(x - jx).max() <= tol * np.abs(jx).max()


def test_ir_solve_fused_operator():
    """The fused operator with the float32 Jacobi diagonal, 6^3 box."""
    jp, js, s = box(6)
    jop64 = js.fused_operator()
    jop32 = jop64.astype(jnp.float32)
    jres = j_mixed.ir_solve(jop64, jop32, js.rhs(0.0), j_operator.diag(jop32),
                            js.bc_dofs, js.bc_step_vals(), rtol=1e-10)
    op64 = operator.build(s)
    op32 = op64.astype(torch.float32)
    assert op32.blocks[0].dNx.dtype == torch.float32
    assert op32.blocks[0].conn.dtype == torch.int64
    F = s.rhs(0.0)
    res = mixed.ir_solve(op64, op32, F, operator.diag(op32), s.bc_dofs,
                         s.bc_step_vals(), rtol=1e-10)
    assert res.resnorm <= 1e-10 * float(torch.linalg.norm(F)) * 1.01
    same(res, jres, 1e-9)
    # float64 accuracy despite float32 inner solves: against pure float64 CG
    mask = torch.zeros(s.ndof, dtype=torch.bool)
    mask[s.bc_dofs] = True
    raw = lambda v: operator.matvec(op64, v)  # noqa: E731
    b = cg.constrained_rhs(raw, F, mask, torch.zeros_like(F))
    d = torch.where(mask, torch.ones_like(F), operator.diag(op64))
    ref = cg.pcg(cg.masked_operator(raw, mask), b, diag=d, rtol=1e-12,
                 maxiter=20000)
    assert float((res.x - ref.x).abs().max()) <= 1e-9 * float(
        ref.x.abs().max())
    # the inner work really happened in float32, over several cycles
    assert res.inner_iters > 0 and res.outer_iters >= 2


def test_ir_solve_with_multigrid_precond():
    """The stencil operator with a float32 multigrid V-cycle, 8^3 box, to
    1e-10 (at fem_tpu's 1e-9 this box sits on the cliff: the second cycle
    ends at 0.88 of the tolerance here and at 1.02 of it in fem_tpu, which
    then runs a third)."""
    n = 8
    jp, js, s = box(n)
    jlam, jmu = j_lame(jnp.asarray(200e9), jnp.asarray(0.3))
    jop64 = j_structured.build((1.0 / n,) * 3, (n + 1,) * 3, jlam, jmu)
    jop32 = jop64.astype(jnp.float32)
    jh32 = j_mg.build(jop32, js.bc_dofs)
    jres = j_mixed.ir_solve(
        jop64, jop32, js.rhs(0.0), j_structured.diag(jop32), js.bc_dofs,
        js.bc_step_vals(), rtol=1e-10, inner_rtol=1e-4,
        apply=j_structured.matvec, precond32=j_mg.preconditioner(jh32))
    lam, mu = lame(torch.tensor(200e9, dtype=torch.float64),
                   torch.tensor(0.3, dtype=torch.float64))
    op64 = structured.build((1.0 / n,) * 3, (n + 1,) * 3, lam, mu,
                            device="cpu")
    op32 = op64.astype(torch.float32)
    h32 = multigrid.build(op32, s.bc_dofs)
    assert h32.coarse_inv.dtype == torch.float32
    F = s.rhs(0.0)
    res = mixed.ir_solve(
        op64, op32, F, structured.diag(op32), s.bc_dofs, s.bc_step_vals(),
        rtol=1e-10, inner_rtol=1e-4, apply=structured.matvec,
        precond32=multigrid.preconditioner(h32))
    assert res.resnorm <= 1e-10 * float(torch.linalg.norm(F)) * 1.01
    # MG inner: far fewer iterations than Jacobi would need at this size
    assert res.inner_iters < 150
    same(res, jres, 1e-9)
