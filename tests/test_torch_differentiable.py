"""Gradients through fem_tpu_torch with torch autograd, against jax.grad of
fem_tpu's functions (port of tests/test_differentiable.py): compliance with
respect to per-element moduli, the hex8 element stiffness with respect to
(lam, mu) and coordinates, the cohesive force with respect to its
properties, and the kernels' autograd: the autograd Functions of K1, K2
and K3, whose backward launches kernels on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.ops import cohesive as j_cohesive
from fem_tpu.ops import elements as j_elements
from fem_tpu.ops import stiffness as j_stiffness
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.ops import (cohesive, cuda_kernels, elements, stiffness,
                               structured)
from fem_tpu_torch.solver import amg

from tests.test_differentiable import _compliance_fn

torch.set_num_threads(1)


def close(got, ref, rtol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def compliance_fn(problem, eltype):
    """F . u(E) of the BC-eliminated dense system of `problem`, a function
    of per-element E (and one nu), in torch on the problem's tensors."""
    et = elements.get(eltype)
    conn = torch.as_tensor(problem.blocks[eltype].conn, dtype=torch.int64)
    ecoords = torch.as_tensor(problem.coords)[conn]
    edofs = stiffness.element_dofs(et, conn)
    n = problem.ndof
    bc = torch.as_tensor(problem.bc_dofs, dtype=torch.int64)
    F = torch.zeros(n, dtype=torch.float64).index_add_(
        0, torch.as_tensor(problem.force_dofs.reshape(-1), dtype=torch.int64),
        torch.as_tensor(problem.force_vec.reshape(-1)))
    mask = torch.zeros(n, dtype=torch.bool)
    mask[bc] = True

    def compliance(E_els, nu):
        lam, mu = stiffness.lame(E_els, torch.full_like(E_els, nu))
        ke = stiffness.element_stiffness_lame(et, ecoords, lam, mu)
        K = torch.zeros((n, n), dtype=E_els.dtype).index_put(
            (edofs[:, :, None], edofs[:, None, :]), ke, accumulate=True)
        Km = torch.where(mask[:, None] | mask[None, :], 0.0, K)
        Km = Km + torch.diag(mask.to(K.dtype))
        u = torch.linalg.solve(Km, torch.where(mask, 0.0, F))
        return F @ u

    return compliance


def test_grad_compliance_matches_jax_and_finite_differences():
    jp = j_meshgen.quad_grid_problem(4, 3, E=100.0, nu=0.3,
                                     tip_force=(0.0, -1.0))
    compliance = compliance_fn(Problem.from_reference(jp), "qua")
    ne = jp.blocks["qua"].ne
    E0 = torch.full((ne,), 100.0, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(compliance(E0, 0.3), E0)
    close(g, jax.grad(_compliance_fn(jp))(jnp.full(ne, 100.0), 0.3),
          rtol=1e-10)
    assert (g < 0).all()  # stiffer anywhere, lower compliance
    h = 1e-4
    with torch.no_grad():
        for e in np.random.default_rng(0).choice(ne, 3, replace=False):
            dE = torch.zeros(ne, dtype=torch.float64)
            dE[e] = h
            fd = (compliance(E0 + dE, 0.3) - compliance(E0 - dE, 0.3)) / (
                2 * h)
            np.testing.assert_allclose(float(g[e]), float(fd), rtol=1e-5)


def test_grad_hex8_stiffness_matches_jax():
    """d<W, k_e(x, lam, mu)>/d(lam, mu, x) for hex8, autograd through the
    plain form of K1 (the CPU wrapper) against jax.grad of fem_tpu's."""
    rng = np.random.default_rng(1)
    ne = 6
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    x = base[None] + 0.1 * rng.normal(size=(ne, 8, 3))
    lam, mu = rng.uniform(1, 2, ne), rng.uniform(1, 2, ne)
    W = rng.normal(size=(ne, 24, 24))
    args = [torch.tensor(a, requires_grad=True) for a in (x, lam, mu)]
    out = (torch.as_tensor(W) * stiffness.element_stiffness_lame(
        elements.get("hex"), *args)).sum()
    grads = torch.autograd.grad(out, args)
    j_et = j_elements.get("hex")
    j_grads = jax.grad(lambda *a: jnp.sum(
        W * j_stiffness.element_stiffness_lame(j_et, *a)), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(lam), jnp.asarray(mu))
    for g, jg in zip(grads, j_grads):
        close(g, jg, rtol=1e-10)


def test_grad_through_cohesive_force():
    """The Xu-Needleman force is linear in sigma_max: dF/dsigma = F/sigma,
    and every property gradient is finite (fem_tpu's check)."""
    ecoords = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 0.0]]],
                           dtype=torch.float64)
    ue = torch.tensor([[0.0, 0.0, 0.0, 0.0, 0.0, 5e-3, 0.0, 5e-3]],
                      dtype=torch.float64)

    def total_force(props):
        f = cohesive.element_force(ecoords, props[None], ue, dt=0.1)
        return f[0, 1::2][:2].sum()

    props = torch.tensor([100.0, 0.01, 0.01, 1.0, 0.0, 0.0],
                         dtype=torch.float64, requires_grad=True)
    F0 = total_force(props)
    (g,) = torch.autograd.grad(F0, props)
    np.testing.assert_allclose(float(g[0]), float(F0.detach()) / 100.0,
                               rtol=1e-10)
    assert torch.isfinite(g).all()
    jg = jax.grad(lambda p: jnp.sum(j_cohesive.element_force(
        jnp.asarray(ecoords.numpy()), p[None], jnp.asarray(ue.numpy()),
        dt=0.1)[0, 1::2][:2]))(jnp.asarray(props.detach().numpy()))
    close(g, jg, rtol=1e-10)


def k1_args(ne, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
    x = np.ascontiguousarray(np.transpose(
        base[None] + 0.05 * rng.normal(size=(ne, 8, 3)), (2, 1, 0)))
    return [torch.as_tensor(a, device=device)
            for a in (x, rng.uniform(1, 2, ne), rng.uniform(1, 2, ne),
                      rng.normal(size=(24, 24, ne)))]


def test_k1_autograd_function_backward(monkeypatch):
    """K1's autograd Function, its launches replaced by the plain forms (the
    kernels run only on the card): the gradients in (lam, mu) equal the
    plain form's autograd, two more launches make them, and the coordinate
    gradient equals it too, from one launch of its own kernel."""
    calls = []

    def plain_launch(*a):
        calls.append(a)
        return cuda_kernels.hex8_stiffness_plain(*a)

    def plain_coord_grad(*a):
        calls.append(a)
        return cuda_kernels.hex8_stiffness_coord_grad_plain(*a)

    monkeypatch.setattr(cuda_kernels, "_hex8_launch", plain_launch)
    monkeypatch.setattr(cuda_kernels, "_hex8_coord_grad_launch",
                        plain_coord_grad)
    x, lam, mu, W = k1_args(7, 2)
    lam.requires_grad_()
    mu.requires_grad_()
    got = torch.autograd.grad(
        (W * cuda_kernels._Hex8Stiffness.apply(x, lam, mu)).sum(), [lam, mu])
    assert len(calls) == 3
    ref = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(x, lam, mu)).sum(), [lam, mu])
    for g, r in zip(got, ref):
        close(g, r, rtol=1e-12)
    xg = x.clone().requires_grad_()
    lam, mu = lam.detach(), mu.detach()
    (got,) = torch.autograd.grad(
        (W * cuda_kernels._Hex8Stiffness.apply(xg, lam, mu)).sum(), [xg])
    assert len(calls) == 5  # its forward and one coordinate-gradient launch
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(xg, lam, mu)).sum(), [xg])
    close(got, ref, rtol=1e-12)


@pytest.mark.cuda
def test_k1_autograd_function_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    x, lam, mu, W = k1_args(4096, 3, device="cuda")
    lam.requires_grad_()
    mu.requires_grad_()
    before = cuda_kernels.launches["hex8_stiffness"]
    got = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness(x, lam, mu)).sum(), [lam, mu])
    assert cuda_kernels.launches["hex8_stiffness"] == before + 3
    ref = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(x, lam, mu)).sum(), [lam, mu])
    for g, r in zip(got, ref):
        close(g, r.cpu(), rtol=1e-12)
    xg = x.clone().requires_grad_()
    lam, mu = lam.detach(), mu.detach()
    before = cuda_kernels.launches["hex8_stiffness_coord_grad"]
    (got,) = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness(xg, lam, mu)).sum(), [xg])
    assert cuda_kernels.launches["hex8_stiffness_coord_grad"] == before + 1
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(xg, lam, mu)).sum(), [xg])
    close(got, ref.cpu(), rtol=1e-12)


def k2_args(shape, seed, device="cpu"):
    """K2's tables of a scalar-material box operator, u and W of its size."""
    op = structured.build((0.1, 0.2, 0.15), shape,
                          torch.tensor(1.5, dtype=torch.float64),
                          torch.tensor(1.0, dtype=torch.float64),
                          dtype=torch.float64, device="cpu")
    t = cuda_kernels.stencil_tables(op.k_ref.to(device), shape)
    rng = np.random.default_rng(seed)
    u, W = (torch.as_tensor(rng.standard_normal(op.ndof), device=device)
            for _ in range(2))
    return t, u, W


def test_k2_autograd_function_backward(monkeypatch):
    """K2's autograd Function, its launches replaced by the plain form: the
    gradient of <W, K u> in u is K W (K is symmetric), one more launch
    makes it, and it equals the plain form's autograd."""
    calls = []

    def plain_launch(t, u):
        calls.append(u)
        return cuda_kernels.stencil27_plain(t, u)

    monkeypatch.setattr(cuda_kernels, "_k2_launch", plain_launch)
    t, u, W = k2_args((6, 5, 4), 4)
    u.requires_grad_()
    (got,) = torch.autograd.grad(
        (W * cuda_kernels._StencilMatvec.apply(t, u)).sum(), u)
    assert len(calls) == 2
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.stencil27_plain(t, u)).sum(), u)
    close(got, ref, rtol=1e-13)
    close(got, cuda_kernels.stencil27_plain(t, W), rtol=1e-13)


@pytest.mark.cuda
def test_k2_autograd_function_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode")
    t, u, W = k2_args((17, 9, 33), 5, device="cuda")
    u.requires_grad_()
    before = cuda_kernels.launches["stencil_matvec"]
    (got,) = torch.autograd.grad(
        (W * cuda_kernels.stencil_matvec(t, u)).sum(), u)
    assert cuda_kernels.launches["stencil_matvec"] == before + 2
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.stencil27_plain(t, u)).sum(), u)
    close(got, ref.cpu(), rtol=1e-12)


@pytest.mark.cuda
def test_k3_gradient_on_card():
    """K3's autograd Function on a 2 x 2 amg.Csr table against the plain
    form's autograd in x and data: two K3 launches (forward, then x's
    backward on the table's kept transpose) and one csr_data_grad launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")
    indptr = torch.tensor([0, 2, 3], dtype=torch.int64, device="cuda")
    indices = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
    data = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64, device="cuda",
                        requires_grad=True)
    x = torch.tensor([1.0, -1.0], dtype=torch.float64, device="cuda",
                     requires_grad=True)
    gy = torch.tensor([0.5, -2.0], dtype=torch.float64, device="cuda")
    t = amg.Csr(indptr, indices, data, 2, 1)
    before = dict(cuda_kernels.launches)
    out = t(x)
    close(out, [-1.0, -3.0], rtol=1e-15)
    got = torch.autograd.grad(out, [x, data], gy)
    assert cuda_kernels.launches["csr_matvec"] == before["csr_matvec"] + 2
    assert (cuda_kernels.launches["csr_data_grad"]
            == before["csr_data_grad"] + 1)
    ref = torch.autograd.grad(cuda_kernels.csr_matvec_plain(
        indptr, indices, data, x), [x, data], gy)
    for g, r in zip(got, ref):
        close(g, r.cpu(), rtol=1e-15)
    close(got[0], [0.5, 7.0], rtol=1e-15)  # A^T gy
    with torch.no_grad():
        out = t(x)
    close(out, [-1.0, -3.0], rtol=1e-15)
