"""The structured row's warm start: each step's MG-CG starts from the last
increment (the reference never zeroes Vec_U), as both of fem_tpu's branches
at or above `structured_big_threshold` do (fem_tpu `stepper.py:506-509,
545-553`; only its small-deck branch starts cold)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu.solver import cg as j_cg
from fem_tpu.solver import multigrid as j_mg
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_structured_warm_start_matches_fem_tpu_big_branch():
    """A 4^3 box (375 DOFs) over 2 equal load steps against fem_tpu's
    non-refinement big branch (structured_big_threshold=0, float32). That
    branch runs whole chunks of 4 iterations, so its counts are the port's
    float32 counts rounded up to a multiple of 4. The second step's load is
    the first's: in float64 the warm start already solves it."""
    jp = j_meshgen.hex_box_problem(4, 4, 4, lx=1.0, ly=1.0, lz=1.0, t=2.0,
                                   dt=1.0)
    jr = j_stepper.run(jp, JConfig(solver="cg", structured_big_threshold=0,
                                   dtype="float32"))
    p = Problem.from_reference(jp)
    r32 = stepper.run(p, Config(device="cpu", solver="cg", dtype="float32"))
    r64 = stepper.run(p, Config(device="cpu", solver="cg"))
    assert r32.path == r64.path == "structured_mg_cg"
    assert [int(i) for i in jr.krylov_iters] == [
        4 * math.ceil(i / 4) for i in r32.krylov_iters]
    # the same answer to the float32 solve's tolerance
    assert rel_max(r32.aggregate_u, jr.aggregate_u) <= 2e-5
    assert rel_max(r64.aggregate_u, jr.aggregate_u) <= 2e-5
    for r in (r32, r64):
        assert r.krylov_iters[1] <= r.krylov_iters[0]
    assert r32.krylov_iters[1] < r32.krylov_iters[0]
    assert r64.krylov_iters[1] == 0


def test_structured_warm_start_counts_match_fem_tpu_pcg_x0():
    """A 6^3 box (1,029 DOFs) over 3 steps whose loads differ (half of the
    tip forces act in the first step only), in float64: per-step iteration
    counts and u against fem_tpu's own stencil operator, Chebyshev hierarchy
    and `cg.pcg` warm-started the way its big branches are,
    x0 = where(bc, ubc, du_prev)."""
    jp = j_meshgen.hex_box_problem(6, 6, 6, lx=1.0, ly=1.0, lz=1.0, t=3.0,
                                   dt=1.0, tip_load=-1e6)
    t2 = jp.force_t2.copy()
    t2[::2] = 1.0
    vec = jp.force_vec.copy()
    vec[::2] *= 0.5
    jp = dataclasses.replace(jp, force_t2=t2, force_vec=vec)
    r = stepper.run(Problem.from_reference(jp), Config(device="cpu",
                                                       solver="cg"))
    assert r.path == "structured_mg_cg"

    js = JSystem(jp)
    spec = j_structured.detect(jp)
    lam, mu = j_lame(jnp.asarray(spec["E"]), jnp.asarray(spec["nu"]))
    op = j_structured.build(spec["cell_sizes"], spec["node_shape"], lam, mu)
    hier = j_mg.build(op, js.bc_dofs, smoother="chebyshev")
    mask = jnp.zeros(jp.ndof, dtype=bool).at[js.bc_dofs].set(True)
    ubc = jnp.zeros(jp.ndof).at[js.bc_dofs].set(js.bc_step_vals())
    raw = lambda v: j_structured.matvec(op, v)  # noqa: E731
    A = j_cg.masked_operator(raw, mask)
    du = jnp.zeros(jp.ndof)
    u = jnp.zeros(jp.ndof)
    iters = []
    for k in range(jp.nsteps):
        b = j_cg.constrained_rhs(raw, js.rhs(jp.dt * k), mask, ubc)
        res = j_cg.pcg(A, b, x0=jnp.where(mask, ubc, du), rtol=1e-9,
                       maxiter=400, precond=j_mg.preconditioner(hier))
        du = jnp.where(mask, ubc, res.x)
        u = u + du
        iters.append(int(res.iters))
    assert r.krylov_iters == iters
    assert rel_max(r.aggregate_u, u) <= 1e-9
    # the loads change after step 1 and not after step 2
    assert 0 < iters[1] <= iters[0] and iters[2] == 0
