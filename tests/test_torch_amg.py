"""fem_tpu_torch's SA-AMG (kernel K3's plain form, the host set-up, the
V-cycle and SA-AMG-CG) against fem_tpu in float64, at small seeded sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import operator as j_op
from fem_tpu.solver import amg as j_amg
from fem_tpu.solver import cg as j_cg
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.ops import operator
from fem_tpu_torch.solver import amg, cg

torch.set_num_threads(1)


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ell_random(n, w, nx, seed, dtype=np.float64):
    """A random (n, w) row-major ELL as fem_tpu stores it, with a few rows
    padded (val 0, col 0) like _to_ell's."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, w)).astype(dtype)
    cols = rng.integers(0, nx, size=(n, w)).astype(np.int32)
    pad = rng.random((n, w)) < 0.1
    vals[pad] = 0.0
    cols[pad] = 0
    return vals, cols, rng.standard_normal(nx).astype(dtype)


def plain(vals, cols, x):
    """K3's plain form on the column-major (w, n) copy of row-major data."""
    return cuda_kernels.ell_matvec_plain(
        torch.as_tensor(np.ascontiguousarray(vals.T)),
        torch.as_tensor(np.ascontiguousarray(cols.T)), torch.as_tensor(x))


def test_k3_plain_matches_fem_tpu_ell_matvec():
    from fem_tpu.ops.pallas_kernels import ell_matvec_pallas

    # tests/test_pallas.py's data (n, w, nx, seed), in float64
    vals, cols, x = ell_random(3000, 13, 2048, seed=3)
    got = plain(vals, cols, x)
    assert rel(got, j_amg._ell_matvec(vals, cols, x)) <= 1e-12
    ref = ell_matvec_pallas(jnp.asarray(vals), jnp.asarray(cols),
                            jnp.asarray(x), block_r=1024, interpret=True)
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("w", [0, 1, 81, 700])
def test_k3_wrapper_on_cpu_is_plain_and_launches_nothing(w):
    vals, cols, x = ell_random(257, w, 300, seed=w)
    args = [torch.as_tensor(np.ascontiguousarray(a.T)) for a in (vals, cols)]
    cuda_kernels.reset_launches()
    got = cuda_kernels.ell_matvec(*args, torch.as_tensor(x))
    assert torch.equal(got, plain(vals, cols, x))
    assert got.shape == (257,) and cuda_kernels.launches["ell_matvec"] == 0
    assert 1 <= cuda_kernels.ell_lanes(w) <= 32


@pytest.mark.cuda
def test_k3_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K3 has no CPU mode)")
    for w in (0, 5, 81, 1500):
        vals, cols, x = ell_random(5000, w, 4000, seed=w)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            v, c, xx = (torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                        for a in (vals.T, cols.T, x))
            v, xx = v.to(dtype), xx.to(dtype)
            before = cuda_kernels.launches["ell_matvec"]
            got = cuda_kernels.ell_matvec(v, c, xx)
            ref = cuda_kernels.ell_matvec_plain(v, c, xx)
            assert cuda_kernels.launches["ell_matvec"] == before + 1
            scale = max(float(ref.abs().max()), 1e-300)
            assert float((got - ref).abs().max()) <= tol * scale
            # a fixed summation order: the same bits every run
            assert torch.equal(got, cuda_kernels.ell_matvec(v, c, xx))


@pytest.fixture(scope="module")
def box():
    """The permuted, jittered 5^3 box in both packages (648 DOFs)."""
    jp = j_meshgen.permute_nodes(
        j_meshgen.hex_box_problem(5, 5, 5, jitter=0.25), seed=0)
    js = JSystem(jp, dtype=jnp.float64)
    s = System(Problem.from_reference(jp), torch.float64, device="cpu")
    return jp, js, s


@pytest.fixture(scope="module")
def hierarchies(box):
    """Both hierarchies from the same assembled matrix (assembly parity is
    checked on its own): the coarsest Galerkin product of the rigid-body
    modes cancels heavily, so 1e-15 differences in A would show there as
    1e-12 differences of the 6x6 coarse inverse."""
    _, js, s = box
    A = j_amg.assemble_csr(js)
    jh = j_amg.build(js, js.bc_dofs, coarse_max=40, dense_level_max=0, A=A)
    h = amg.build(s, s.bc_dofs, coarse_max=40, dense_level_max=0, A=A)
    return jh, h


def ell_dense(e, ncols):
    """Dense matrix of a column-major ELL table."""
    vals, cols = np.asarray(e.vals), np.asarray(e.cols).astype(np.int64)
    out = np.zeros((vals.shape[1], ncols))
    rows = np.broadcast_to(np.arange(vals.shape[1]), vals.shape)
    np.add.at(out, (rows, cols), vals)
    return out


def test_assemble_csr_matches_fem_tpu(box):
    _, js, s = box
    A, jA = amg.assemble_csr(s), j_amg.assemble_csr(js)
    assert rel(A.toarray(), jA.toarray()) <= 1e-12
    assert (A.indptr == jA.indptr).all() and (A.indices == jA.indices).all()


def test_amg_build_matches_fem_tpu(hierarchies):
    jh, h = hierarchies
    assert len(h.levels) == len(jh.levels) >= 3  # ELL mid levels exist
    for i, (lv, jlv) in enumerate(zip(h.levels, jh.levels)):
        assert lv.n_coarse == jlv.n_coarse
        assert abs(lv.theta - jlv.theta) <= 1e-12 * jlv.theta
        assert abs(lv.delta - jlv.delta) <= 1e-12 * jlv.delta
        assert rel(lv.dinv, jlv.dinv) <= 1e-12
        n = lv.dinv.shape[0]
        if lv.n_coarse:
            jP = ell_dense(amg.Ell(np.asarray(jlv.p_vals).T,
                                   np.asarray(jlv.p_cols).T), lv.n_coarse)
            assert rel(ell_dense(lv.P, lv.n_coarse), jP) <= 1e-12
            assert rel(ell_dense(lv.R, n), jP.T) <= 1e-12
        if 0 < i < len(h.levels) - 1:  # Galerkin A_c of the level above
            jA = ell_dense(amg.Ell(np.asarray(jlv.ell_vals).T,
                                   np.asarray(jlv.ell_cols).T), n)
            assert rel(ell_dense(lv.op, n), jA) <= 1e-12
    assert rel(h.coarse_inv, jh.coarse_inv) <= 1e-12


def masked_pair(box):
    """The masked fused operator of both packages, and the RHS."""
    jp, js, s = box
    jfop = j_op.build(js)
    jmask = jnp.zeros(js.ndof, bool).at[js.bc_dofs].set(True)
    jA = j_cg.masked_operator(lambda v: j_op.matvec(jfop, v), jmask)
    fop = operator.build(s)
    mask = torch.zeros(s.ndof, dtype=torch.bool)
    mask[s.bc_dofs] = True
    A = cg.masked_operator(lambda v: operator.matvec(fop, v), mask)
    b = np.where(np.asarray(jmask), 0.0, np.asarray(js.rhs(0.0)))
    return jA, A, b


def test_v_cycle_on_carried_hierarchy_matches_fem_tpu(box, hierarchies):
    jh, _ = hierarchies
    jA, A, b = masked_pair(box)
    h = amg.from_reference(jh)
    r = np.random.default_rng(5).standard_normal(b.shape[0])
    got = amg.v_cycle(h, A, torch.as_tensor(r))
    assert rel(got, j_amg.v_cycle(jh, jA, jnp.asarray(r))) <= 1e-10


def test_sa_amg_cg_matches_fem_tpu(box, hierarchies):
    jh, h = hierarchies
    jA, A, b = masked_pair(box)
    jres = j_cg.pcg(jA, jnp.asarray(b), rtol=1e-9, maxiter=200,
                    precond=j_amg.preconditioner(jh, jA))
    res = cg.pcg(A, torch.as_tensor(b), rtol=1e-9, maxiter=200,
                 precond=amg.preconditioner(h, A))
    assert res.resnorm <= 1e-9 * np.linalg.norm(b)
    assert res.iters == int(jres.iters)
    assert rel(res.x, jres.x) <= 1e-9


def test_dense_inverse_raises_when_not_positive_definite():
    with pytest.raises(RuntimeError, match="not positive definite"):
        amg._dense_inv(np.diag([1.0, -1.0, 2.0]), "cpu")
    K = np.array([[4.0, 1.0], [1.0, 3.0]])
    np.testing.assert_allclose(amg._dense_inv(K, "cpu").numpy(),
                               np.linalg.inv(K), rtol=1e-14)


def test_permute_nodes_matches_fem_tpu():
    jp = j_meshgen.permute_nodes(j_meshgen.hex_box_problem(3, 2, 2), seed=4)
    p = meshgen.permute_nodes(meshgen.hex_box_problem(3, 2, 2), seed=4)
    for name in ("coords", "bc_dofs", "force_dofs", "trac_dofs"):
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name))
    np.testing.assert_array_equal(p.blocks["hex"].conn, jp.blocks["hex"].conn)
