"""Kernel K2's plain versions against the Pallas kernel in interpret mode,
fem_tpu's structured.matvec and its collapsed matvec_planes27; K2's tables
against fem_tpu's csum; the stencil operator's reference pair against
fem_tpu's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.pallas_kernels import stencil_matvec_pallas
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu_torch.ops import cuda_kernels, structured
from fem_tpu_torch.solver import multigrid

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


# K2's tables on grids with axes of two nodes and of one (no cell: K.u = 0)
DEGENERATE = [(2, 2, 2), (3, 2, 9), (1, 4, 5)]


def test_k2_interior_table_matches_fem_tpu_csum():
    op, jop = pair((9, 7, 6))
    _, A, B, V = j_structured._pair_tables(3)
    k = np.asarray(jop.lam * jop.k_lam + jop.mu * jop.k_mu).reshape(8, 3, 8, 3)
    csum = (k[A, :, B, :] * V[:, :, None, None]).sum(axis=1)  # (27, 3, 3)
    got = op.tables.coef[13].numpy()
    assert np.abs(got - csum).max() <= 1e-13 * np.abs(csum).max()
    np.testing.assert_array_equal(op.tables.interior.numpy(), got.reshape(-1))
    assert cuda_kernels.STENCIL_OFFSETS == j_structured._pair_tables(3)[0]


@pytest.mark.parametrize("cells", [(1 / 80,) * 3, CELLS])
def test_k2_interior_table_has_the_structural_zeros(cells):
    """The p != q couplings at offsets with a zero component along p or q
    vanish in the interior (12 of 27 offsets have both components nonzero):
    90 of the 243 coefficients are 0 to rounding."""
    op, _ = pair((5, 5, 5), cells)
    c = op.tables.coef[13].numpy()
    zero = np.abs(c) <= 1e-13 * np.abs(c).max()
    assert zero.sum() == 90
    for oi, o in enumerate(cuda_kernels.STENCIL_OFFSETS):
        for p in range(3):
            for q in range(3):
                assert zero[oi, p, q] == (p != q and (o[p] == 0 or o[q] == 0))


@pytest.mark.parametrize("shape", [(9, 7, 6)] + DEGENERATE)
def test_k2_tables_plain_matches_corner_form_and_planes27(shape):
    op, jop = pair(shape)
    u = np.random.default_rng(2).standard_normal(op.ndof)
    got = cuda_kernels.stencil27_plain(op.tables, torch.as_tensor(u)).numpy()
    corner = cuda_kernels.stencil_matvec_plain(op.k_ref, torch.as_tensor(u),
                                               shape).numpy()
    planes27 = np.asarray(j_structured.matvec_planes27(jop, jnp.asarray(u)))
    scale = np.abs(corner).max() if 1 not in shape else 1.0
    for ref in (corner, planes27):
        assert np.abs(got - ref).max() <= 1e-13 * scale
    if 1 in shape:
        assert not got.any()


def test_k2_tables_follow_the_operator():
    """k_ref and the tables are built with the operator, and a coarse MG
    level (a dataclasses.replace copy) gets its own."""
    op, _ = pair((9, 7, 6))
    k_ref = op.lam * op.k_lam + op.mu * op.k_mu
    assert torch.equal(op.k_ref, k_ref) and op.tables.shape == (9, 7, 6)
    coarse = dataclasses.replace(op, k_lam=op.k_lam * 2, k_mu=op.k_mu * 2,
                                 shape=(5, 4, 3))
    assert torch.equal(coarse.k_ref, 2 * k_ref)
    assert coarse.tables.shape == (5, 4, 3)
    assert torch.equal(coarse.tables.coef[13], 2 * op.tables.coef[13])
    op32, _ = pair((9, 7, 6), dtype=np.float32)
    assert op32.tables.coef.dtype == op32.tables.interior.dtype == torch.float32


def test_k2_tables_on_every_mg_level():
    """The operators multigrid.build makes for the coarse levels (17^3 down
    to 3^3 nodes) each apply their own tables as the per-corner form does."""
    op, _ = pair((17, 17, 17), (1 / 16,) * 3)
    bc = torch.arange(17 * 17 * 3)  # the x = 0 face
    h = multigrid.build(op, bc)
    assert [lv.op.shape for lv in h.levels] == [(n,) * 3 for n in (17, 9, 5, 3)]
    for i, lv in enumerate(h.levels):
        u = torch.as_tensor(np.random.default_rng(i).standard_normal(
            lv.op.ndof))
        corner = cuda_kernels.stencil_matvec_plain(lv.op.k_ref, u,
                                                   lv.op.shape)
        assert rel(structured.matvec(lv.op, u), corner.numpy()) < 1e-13


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K2 has no CPU mode)")
    for shape in SHAPES + DEGENERATE + [(17, 9, 33), (41, 41, 41)]:
        op, _ = pair(shape)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            k = op.k_ref.to(dtype=dtype, device="cuda").contiguous()
            t = cuda_kernels.stencil_tables(k, shape)
            u = torch.randn(op.ndof, dtype=dtype, device="cuda")
            before = cuda_kernels.launches["stencil_matvec"]
            got = cuda_kernels.stencil_matvec(t, u)
            assert cuda_kernels.launches["stencil_matvec"] == before + 1
            ref = cuda_kernels.stencil_matvec_plain(k, u, shape)
            if 1 in shape:
                assert not got.any()
            else:
                assert rel(got, ref.cpu().numpy()) < tol
                assert rel(got, cuda_kernels.stencil27_plain(t, u).cpu()
                           .numpy()) < tol
            # a fixed summation order: the same bits every run
            assert torch.equal(got, cuda_kernels.stencil_matvec(t, u))


@pytest.mark.parametrize("cells", [(0.1, 0.2, 0.15), (0.5, 0.25)])
def test_build_reference_pair(cells):
    shape = (5, 4, 3) if len(cells) == 3 else (5, 4)
    op, jop = pair(shape, cells)
    for a, b in ((op.k_lam, jop.k_lam), (op.k_mu, jop.k_mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * np.abs(np.asarray(b)).max())
