"""fem_tpu_torch's unstructured linear path against fem_tpu in float64: the
fused operator, the block stencil, the lattice GMG cycle, and the stepper's
unstructured_amg_or_lattice_gmg_cg row against the direct solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import blockstencil as j_bs
from fem_tpu.ops import operator as j_op
from fem_tpu.solver import amg as j_amg
from fem_tpu.solver import gmg as j_gmg
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import blockstencil, operator
from fem_tpu_torch.solver import cg, gmg, stepper

torch.set_num_threads(1)

PATH = "unstructured_amg_or_lattice_gmg_cg"


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jittered_quad_grid(nx, ny, seed=0):
    """fem_tpu's 2D lattice deck (tests/test_gmg.py): interior nodes
    jittered, so the connectivity is a lattice but the geometry is not a
    uniform box."""
    p = j_meshgen.quad_grid_problem(nx, ny, E=100.0, nu=0.3,
                                    tip_force=(0.0, -1.0))
    rng = np.random.default_rng(seed)
    c = p.coords
    interior = ((c[:, 0] > 0) & (c[:, 0] < 1.0 - 1e-9)
                & (c[:, 1] > 0) & (c[:, 1] < 1.0 - 1e-9))
    c[interior] += 0.02 * (rng.random((int(interior.sum()), 2)) - 0.5)
    return p


def pair(jp):
    """A fem_tpu problem as a fem_tpu System and a port System."""
    return (JSystem(jp, dtype=jnp.float64),
            System(Problem.from_reference(jp), torch.float64, device="cpu"))


@pytest.mark.parametrize("problem", [
    lambda: j_meshgen.permute_nodes(j_meshgen.hex_box_problem(
        4, 3, 3, jitter=0.3)),
    lambda: jittered_quad_grid(6, 5),
])
def test_fused_operator_matches_fem_tpu(problem):
    js, s = pair(problem())
    jop, op = j_op.build(js), operator.build(s)
    u = np.random.default_rng(2).standard_normal(s.ndof)
    assert rel(operator.matvec(op, torch.as_tensor(u)),
               j_op.matvec(jop, jnp.asarray(u))) <= 1e-12
    assert rel(operator.diag(op), j_op.diag(jop)) <= 1e-12


@pytest.mark.parametrize("problem", [
    lambda: j_meshgen.hex_box_problem(4, 3, 5, jitter=0.25),
    lambda: jittered_quad_grid(7, 4),
    lambda: j_meshgen.permute_nodes(j_meshgen.hex_box_problem(3, 3, 3)),
])
def test_blockstencil_matches_fem_tpu(problem):
    js, s = pair(problem())
    A = j_amg.assemble_csr(js)
    dims = blockstencil.detect(A, s.pdim, s.nnds)
    assert dims == j_bs.detect(A, s.pdim, s.nnds)
    if dims is None:  # the permuted box is no lattice
        return
    op = blockstencil.build(A, s.pdim, dims, device="cpu")
    jop = j_bs.build(A, s.pdim, dims)
    u = np.random.default_rng(3).standard_normal(s.ndof)
    assert rel(blockstencil.matvec(op, torch.as_tensor(u)),
               j_bs.matvec(jop, jnp.asarray(u))) <= 1e-12
    assert rel(blockstencil.matvec(op, torch.as_tensor(u)), A @ u) <= 1e-12


def test_v_cycle_g_matches_fem_tpu_on_2d_lattice():
    js, s = pair(jittered_quad_grid(12, 9))
    A = j_amg.assemble_csr(js)
    dims = j_bs.detect(A, 2, s.nnds)
    jh = j_gmg.build_lattice(A, 2, dims, bc_dofs=js.bc_dofs,
                             dtype=jnp.float64, coarse_max=20)
    h = gmg.build_lattice(A, 2, dims, bc_dofs=s.bc_dofs, coarse_max=20)
    assert len(h.levels) == len(jh.levels) >= 2
    assert h.coarse_dims == jh.coarse_dims
    # fem_tpu's grid state is (pdim, *dims), the port's (*dims, pdim)
    mask = np.zeros(s.ndof)
    mask[s.bc_dofs.numpy()] = 1.0
    jop = j_bs.build(A, 2, dims)
    mf_g = jnp.asarray(mask.reshape(*dims, 2).transpose(2, 0, 1))

    def jmv_g(v):
        return j_bs.matvec_g(jop, v * (1 - mf_g)) * (1 - mf_g) + v * mf_g

    op = blockstencil.build(A, 2, dims, device="cpu")
    masked = cg.masked_operator(lambda v: blockstencil.matvec(op, v),
                                torch.as_tensor(mask > 0))
    r = np.random.default_rng(4).standard_normal(s.ndof)
    ref = j_gmg.v_cycle_g(jh, jmv_g,
                          jnp.asarray(r.reshape(*dims, 2).transpose(2, 0, 1)))
    got = gmg.preconditioner(h, masked)(torch.as_tensor(r))
    assert rel(got, np.asarray(ref).transpose(1, 2, 0).reshape(-1)) <= 1e-10


def direct_u(p):
    return stepper.run(p, Config(device="cpu", solver="direct")).aggregate_u


def test_stepper_sa_amg_matches_direct_and_warm_starts():
    """Permuted jittered box, 2 steps of a constant ramp: the SA-AMG route
    matches the direct solve to 1e-7 and step 2, warm-started from step 1's
    increment, takes no iteration."""
    p = meshgen.permute_nodes(meshgen.hex_box_problem(
        6, 6, 6, lx=1.0, ly=1.0, lz=1.0, jitter=0.25, t=2.0, dt=1.0))
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg", precond="amg"),
                    log=msgs.append)
    assert r.path == PATH and r.nsteps == 2
    assert any("smoothed aggregation" in m for m in msgs)
    assert not any("Lattice topology" in m for m in msgs)
    assert r.krylov_iters[0] > 0 and r.krylov_iters[1] == 0
    ud = direct_u(p)
    assert rel(r.aggregate_u, ud) <= 1e-7


def test_stepper_runs_lattice_gmg_branch():
    p = meshgen.hex_box_problem(6, 5, 5, lx=1.0, ly=1.0, lz=1.0, jitter=0.25)
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg", precond="amg",
                              gmg_min=1), log=msgs.append)
    assert r.path == PATH
    assert any("Lattice topology" in m for m in msgs)
    assert any("Geometric lattice-MG" in m for m in msgs)
    assert not any("demotion" in m for m in msgs)
    assert rel(r.aggregate_u, direct_u(p)) <= 1e-7


def test_stepper_demotes_poisoned_gmg(monkeypatch):
    """A GMG cycle that returns NaN (fem_tpu's tests/test_gmg.py model of a
    corrupt cycle) fails the acceptance check; the stepper demotes to SA-AMG
    and still matches the direct solve."""
    p = Problem.from_reference(jittered_quad_grid(10, 6))
    real_v = gmg.v_cycle_g
    monkeypatch.setattr(gmg, "v_cycle_g",
                        lambda h, mv, r: real_v(h, mv, r) * torch.nan)
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg", precond="amg",
                              gmg_min=1), log=msgs.append)
    assert any("Geometric lattice-MG" in m for m in msgs)
    assert any("SA-AMG demotion" in m for m in msgs)
    ud = direct_u(p)
    assert rel(r.aggregate_u, ud) <= 1e-7

