"""Kernel K2's plain version against the Pallas kernel in interpret mode and
against fem_tpu's structured.matvec, and the stencil operator's reference
pair against fem_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.pallas_kernels import stencil_matvec_pallas
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu_torch.ops import cuda_kernels, structured

torch.set_num_threads(1)

LAM, MU = j_lame(200e9, 0.3)
SHAPES = [(9, 7, 6), (8, 5, 5), (6, 6, 6)]  # tests/test_pallas.py:71
CELLS = (0.1, 0.2, 0.15)


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pair(shape, cells=CELLS, lam=LAM, mu=MU, dtype=np.float64):
    """The same operator from both packages."""
    jop = j_structured.build(cells, shape, jnp.asarray(lam, dtype),
                             jnp.asarray(mu, dtype), dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    op = structured.build(cells, shape, torch.as_tensor(np.asarray(lam), dtype=tdt),
                          torch.as_tensor(np.asarray(mu), dtype=tdt),
                          dtype=tdt, device="cpu")
    return op, jop


@pytest.mark.parametrize("shape,bx", [((9, 7, 6), 4), ((8, 5, 5), 3),
                                      ((6, 6, 6), 8)])
def test_k2_plain_matches_pallas_f32(shape, bx):
    _, jop = pair(shape, dtype=np.float32)
    k = np.array(jop.lam * jop.k_lam + jop.mu * jop.k_mu)
    u = np.random.default_rng(0).standard_normal(jop.ndof).astype(np.float32)
    ref = np.asarray(stencil_matvec_pallas(jnp.asarray(k), jnp.asarray(u),
                                           shape, block_x=bx, interpret=True))
    got = cuda_kernels.stencil_matvec_plain(torch.as_tensor(k),
                                            torch.as_tensor(u), shape)
    assert got.dtype == torch.float32
    assert rel(got, ref) < 1e-6


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_plain_matches_structured_matvec_f64(shape):
    op, jop = pair(shape)
    u = np.random.default_rng(1).standard_normal(jop.ndof)
    ref = j_structured.matvec(jop, jnp.asarray(u))
    assert rel(cuda_kernels.stencil_matvec_plain(op.k_ref, torch.as_tensor(u),
                                                 shape), ref) < 1e-12
    cuda_kernels.reset_launches()
    assert rel(structured.matvec(op, torch.as_tensor(u)), ref) < 1e-12
    assert cuda_kernels.launches["stencil_matvec"] == 0


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K2 has no CPU mode)")
    for shape in SHAPES + [(17, 9, 33)]:
        op, _ = pair(shape)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            k = op.k_ref.to(dtype=dtype, device="cuda").contiguous()
            u = torch.randn(op.ndof, dtype=dtype, device="cuda")
            got = cuda_kernels.stencil_matvec(k, u, shape)
            ref = cuda_kernels.stencil_matvec_plain(k, u, shape)
            assert rel(got, ref.cpu().numpy()) < tol


@pytest.mark.parametrize("cells", [(0.1, 0.2, 0.15), (0.5, 0.25)])
def test_build_reference_pair(cells):
    shape = (5, 4, 3) if len(cells) == 3 else (5, 4)
    op, jop = pair(shape, cells)
    for a, b in ((op.k_lam, jop.k_lam), (op.k_mu, jop.k_mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * np.abs(np.asarray(b)).max())
