"""fem_tpu_torch element math against fem_tpu in float64, and kernel K1's
plain version against the batch-last XLA form and the Pallas kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import dmat as j_dmat
from fem_tpu.ops import elements as j_elements
from fem_tpu.ops import stiffness as j_stiff
from fem_tpu.ops.pallas_kernels import hex8_stiffness_pallas
from fem_tpu_torch.ops import cuda_kernels, dmat, elements, stiffness

torch.set_num_threads(1)

RTOL = 1e-13  # float64, same formulas, summation order may differ

TEMPLATES = {
    "tri": [[0, 0], [1, 0], [0, 1]],
    "qua": [[0, 0], [1, 0], [1, 1], [0, 1]],
    "tet": [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
    "hex": [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
}


def close(got, ref, rtol=RTOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def inputs(name, ne=7, seed=0):
    rng = np.random.default_rng(seed)
    base = np.asarray(TEMPLATES[name], dtype=float)
    ec = base[None] * 0.3 + 0.02 * rng.normal(size=(ne,) + base.shape)
    E = rng.uniform(1e3, 2e3, ne)
    nu = rng.uniform(0.1, 0.4, ne)
    ue = rng.normal(size=(ne, base.size))
    return ec, E, nu, ue


@pytest.mark.parametrize("name", ["tri", "qua", "tet", "hex"])
def test_element_functions_match_fem_tpu(name):
    et, jet = elements.get(name), j_elements.get(name)
    ec, E, nu, ue = inputs(name)
    t = torch.as_tensor
    pdim = et.pdim
    D = dmat.dmat(t(E), t(nu), pdim)
    close(D, j_dmat.dmat(E, nu, pdim))
    dNx, detj = stiffness.grad_and_detj(et, t(ec))
    jdNx, jdetj = j_stiff.grad_and_detj(jet, jnp.asarray(ec))
    close(dNx, jdNx)
    close(detj, jdetj)
    close(stiffness.bmat(dNx, pdim), j_stiff.bmat(jdNx, pdim))
    close(stiffness.element_stiffness(et, t(ec), D),
          j_stiff.element_stiffness(jet, jnp.asarray(ec), np.asarray(
              j_dmat.dmat(E, nu, pdim))))
    lam, mu = stiffness.lame(t(E), t(nu))
    jlam, jmu = j_stiff.lame(E, nu)
    close(lam, jlam)
    close(mu, jmu)
    close(stiffness.element_stiffness_isotropic(et, t(ec), t(E), t(nu)),
          j_stiff.element_stiffness_isotropic(jet, jnp.asarray(ec), E, nu))
    close(stiffness.element_stiffness_lame(et, t(ec), lam, mu),
          j_stiff.element_stiffness_lame(jet, jnp.asarray(ec), jlam, jmu))
    ec_l = np.ascontiguousarray(np.transpose(ec, (2, 1, 0)))
    close(stiffness.element_stiffness_lame_batchlast(et, t(ec_l), lam, mu),
          j_stiff.element_stiffness_lame_batchlast(jet, jnp.asarray(ec_l),
                                                   jlam, jmu))
    sig = stiffness.element_stress(et, t(ec), t(ue), D)
    jsig = j_stiff.element_stress(jet, jnp.asarray(ec), jnp.asarray(ue),
                                  np.asarray(j_dmat.dmat(E, nu, pdim)))
    close(sig, jsig)
    close(stiffness.nodal_stress(et, sig), j_stiff.nodal_stress(jet, jsig))
    conn = np.arange(7 * et.nnodes).reshape(7, et.nnodes)[::-1].copy()
    close(stiffness.element_dofs(et, t(conn)),
          j_stiff.element_dofs(jet, jnp.asarray(conn)), rtol=0)


BASE = np.asarray(TEMPLATES["hex"], dtype=float)


def k1_setup(ne, seed=0):
    """tests/test_pallas.py's K1 inputs."""
    rng = np.random.default_rng(seed)
    ec = np.transpose(BASE[None] + 0.05 * rng.normal(size=(ne, 8, 3)),
                      (2, 1, 0))
    return np.ascontiguousarray(ec), rng.uniform(1, 2, ne), rng.uniform(1, 2, ne)


@pytest.mark.parametrize("ne,pallas", [(128, False), (300, True)])
def test_k1_plain_matches_xla_and_pallas(ne, pallas):
    """ne=300 over Pallas blocks of 128: padding and several blocks. (The
    interpret-mode Pallas run takes ~8 s, so only this case pays it.)"""
    ec, lam, mu = k1_setup(ne, seed=0 if ne == 128 else 1)
    got = cuda_kernels.hex8_stiffness_plain(
        *(torch.as_tensor(a) for a in (ec, lam, mu))).numpy()
    assert got.shape == (24, 24, ne)
    ref = np.asarray(j_stiff.element_stiffness_lame_batchlast(
        j_elements.get("hex"), jnp.asarray(ec), jnp.asarray(lam),
        jnp.asarray(mu))).reshape(24, 24, -1)
    others = [ref]
    if pallas:
        others.append(np.asarray(hex8_stiffness_pallas(
            jnp.asarray(ec), jnp.asarray(lam), jnp.asarray(mu), block_e=128,
            interpret=True)))
    for other in others:
        np.testing.assert_allclose(got, other, rtol=1e-13,
                                   atol=1e-13 * np.abs(other).max())


def test_k1_plain_symmetric():
    ec, lam, mu = k1_setup(64, seed=2)
    got = cuda_kernels.hex8_stiffness_plain(
        *(torch.as_tensor(a) for a in (ec, lam, mu))).numpy()
    np.testing.assert_allclose(got, np.transpose(got, (1, 0, 2)), atol=1e-12)


def test_k1_wrapper_on_cpu_is_plain_and_launches_nothing():
    cuda_kernels.reset_launches()
    args = [torch.as_tensor(a) for a in k1_setup(20, seed=4)]
    assert torch.equal(cuda_kernels.hex8_stiffness(*args),
                       cuda_kernels.hex8_stiffness_plain(*args))
    assert cuda_kernels.launches["hex8_stiffness"] == 0


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K1 has no CPU mode)")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = [torch.as_tensor(a, dtype=dtype, device="cuda")
                for a in k1_setup(1000, seed=5)]
        before = cuda_kernels.launches["hex8_stiffness"]
        got = cuda_kernels.hex8_stiffness(*args)
        ref = cuda_kernels.hex8_stiffness_plain(*args)
        assert cuda_kernels.launches["hex8_stiffness"] == before + 1
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
