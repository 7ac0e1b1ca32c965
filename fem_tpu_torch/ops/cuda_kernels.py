"""Hand-written Hopper kernels of the port, with their plain torch versions.

Counterpart of `fem_tpu/ops/pallas_kernels.py`. For each kernel this module
holds the plain torch version (what the CPU tests run and what the kernel is
checked against on the card), the wrapper, and a launch count.

  K1 hex8_stiffness   csrc/hex8_stiffness.cu  replaces hex8_stiffness_pallas
  K2 stencil_matvec   csrc/stencil_matvec.cu  replaces stencil_matvec_pallas
  K3 ell_matvec       csrc/ell_matvec.cu      replaces ell_matvec_pallas

A wrapper given a CPU tensor returns the plain version. Given a CUDA tensor
it launches the kernel (built at first use by `fem_tpu_torch.kernels_build`)
on the current stream or raises; there is no fallback. `launches[name]` is
incremented once per kernel launch and nowhere else.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_tpu_torch.ops import elements

# Grid-index corner offsets matching the element node ordering of meshgen's
# builders (fem_tpu/ops/structured.py:47-52). 3D: nodes numbered z-fastest,
# hex8 nodes bottom face CCW then top face — grid offsets equal coordinate
# offsets. 2D: quad_grid_problem numbers nodes y-major, so grid offsets are
# (dy, dx) while the element corners stay (x, y)-ordered.
HEX_OFFSETS = (
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
)
QUAD_OFFSETS = ((0, 0), (0, 1), (1, 1), (1, 0))

launches = {"hex8_stiffness": 0, "stencil_matvec": 0, "ell_matvec": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1


def _float_suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise ValueError(f"CUDA kernels take float32 or float64, got {dtype}")


# --------------------------------------------------------------------------
# K1: hex8 element stiffness
# --------------------------------------------------------------------------


def hex8_stiffness_plain(ecoords_l, lam, mu):
    """Plain form of K1: (3, 8, ne) coordinates, (ne,) lam and mu ->
    (24, 24, ne) element stiffnesses, rows/cols in a*3+p dof order."""
    from fem_tpu_torch.ops import stiffness  # stiffness imports this module

    ke = stiffness.element_stiffness_lame_batchlast(
        elements.get("hex"), ecoords_l, lam, mu)
    return ke.reshape(24, 24, ecoords_l.shape[-1])


def hex8_stiffness(ecoords_l, lam, mu):
    """K1 wrapper: same contract as hex8_stiffness_plain."""
    if ecoords_l.device.type == "cpu":
        return hex8_stiffness_plain(ecoords_l, lam, mu)
    _check(ecoords_l.is_cuda, f"unsupported device {ecoords_l.device}")
    suffix = _float_suffix(ecoords_l.dtype)
    ne = ecoords_l.shape[-1] if ecoords_l.dim() == 3 else -1
    _check(ecoords_l.shape == (3, 8, ne), f"ecoords_l must be (3, 8, ne), got "
           f"{tuple(ecoords_l.shape)}")
    for name, t in (("lam", lam), ("mu", mu)):
        _check(t.shape == (ne,), f"{name} must be ({ne},), got {tuple(t.shape)}")
        _check(t.dtype == ecoords_l.dtype and t.device == ecoords_l.device,
               f"{name} must match ecoords_l's dtype and device")
    for t in (ecoords_l, lam, mu):
        _check(t.is_contiguous(), "K1 inputs must be contiguous")
    out = torch.empty((24, 24, ne), dtype=ecoords_l.dtype,
                      device=ecoords_l.device)
    if ne == 0:
        return out
    from fem_tpu_torch import kernels_build

    fn = getattr(kernels_build.library(), f"hex8_stiffness_{suffix}")
    with torch.cuda.device(ecoords_l.device):
        _launch("hex8_stiffness", fn, ecoords_l.data_ptr(), lam.data_ptr(),
                mu.data_ptr(), out.data_ptr(), ne,
                torch.cuda.current_stream().cuda_stream)
    return out


# --------------------------------------------------------------------------
# K2: structured-grid stencil matvec
# --------------------------------------------------------------------------


def _cell_mask(shape, off, like):
    """Float indicator over the node grid: 1 where the cell at node - off
    exists (0 <= node - off <= n - 2 on every axis)."""
    mask = None
    for ax, n in enumerate(shape):
        x = np.arange(n) - off[ax]
        m_shape = [1] * len(shape)
        m_shape[ax] = n
        m = torch.as_tensor(((x >= 0) & (x <= n - 2)).reshape(m_shape),
                            dtype=like.dtype, device=like.device)
        mask = m if mask is None else mask * m
    return mask


def stencil_matvec_plain(k_ref, u, shape):
    """Plain form of K2 (the semantics of fem_tpu's structured._planes_core)
    for 2D or 3D node grids:

        out_p[n] = sum_a M_a[n] sum_{b,q} k[a,p,b,q] u_q[n - off_a + off_b]

    k_ref: (nn*pdim, nn*pdim) scalar-material element stiffness; u: (ndof,)
    node-interleaved over the node grid `shape`; returns (ndof,). Each shifted
    read is a slice of a zero-padded component-planes tensor; M_a masks the
    corners whose cell does not exist.
    """
    shape = tuple(int(n) for n in shape)
    pdim = len(shape)
    offs = HEX_OFFSETS if pdim == 3 else QUAD_OFFSETS
    nn = len(offs)
    k = k_ref.reshape(nn, pdim, nn, pdim)
    U = F.pad(u.reshape(*shape, pdim).movedim(-1, 0), [1, 1] * pdim)
    out = torch.zeros((pdim,) + shape, dtype=u.dtype, device=u.device)
    for a, off_a in enumerate(offs):
        # the 8 (4) neighbours u[n - off_a + off_b], stacked over b
        S = torch.stack([
            U[(slice(None),) + tuple(
                slice(1 + ob - oa, 1 + ob - oa + n)
                for oa, ob, n in zip(off_a, off_b, shape))]
            for off_b in offs
        ])  # (nn, pdim, *shape)
        acc = torch.tensordot(k[a], S, dims=([1, 2], [0, 1]))  # (pdim, *shape)
        out += _cell_mask(shape, off_a, u) * acc
    return out.movedim(0, -1).reshape(-1)


def stencil_matvec(k_ref, u, shape):
    """K2 wrapper for 3D node grids: same contract as stencil_matvec_plain."""
    if u.device.type == "cpu":
        return stencil_matvec_plain(k_ref, u, shape)
    _check(u.is_cuda, f"unsupported device {u.device}")
    suffix = _float_suffix(u.dtype)
    _check(len(shape) == 3, f"K2 takes a 3D node grid, got shape {shape}")
    nx, ny, nz = (int(n) for n in shape)
    _check(min(nx, ny, nz) >= 1, f"empty node grid {shape}")
    _check(u.shape == (nx * ny * nz * 3,),
           f"u must be ({nx * ny * nz * 3},), got {tuple(u.shape)}")
    _check(k_ref.shape == (24, 24), f"k_ref must be (24, 24), got "
           f"{tuple(k_ref.shape)}")
    _check(k_ref.dtype == u.dtype and k_ref.device == u.device,
           "k_ref must match u's dtype and device")
    _check(u.is_contiguous() and k_ref.is_contiguous(),
           "K2 inputs must be contiguous")
    out = torch.empty_like(u)
    from fem_tpu_torch import kernels_build

    fn = getattr(kernels_build.library(), f"stencil_matvec_{suffix}")
    with torch.cuda.device(u.device):
        _launch("stencil_matvec", fn, k_ref.data_ptr(), u.data_ptr(),
                out.data_ptr(), nx, ny, nz,
                torch.cuda.current_stream().cuda_stream)
    return out


# --------------------------------------------------------------------------
# K3: ELL sparse matrix-vector product
# --------------------------------------------------------------------------


def ell_matvec_plain(vals, cols, x):
    """Plain form of K3 on the column-major (w, n) ELL layout:
    out[i] = sum_k vals[k, i] * x[cols[k, i]]; padded slots (val 0, col 0)
    give 0. vals: (w, n) float, cols: (w, n) int32, x: (nx,) -> (n,)."""
    return (vals * x[cols]).sum(0)


def ell_lanes(w: int) -> int:
    """Threads sharing one row in K3: the largest power of two <= 32 with at
    least 16 slots per thread (1 for rows narrower than 32 slots)."""
    lanes = 1
    while lanes < 32 and 32 * lanes <= w:
        lanes *= 2
    return lanes


def ell_matvec(vals, cols, x):
    """K3 wrapper: same contract as ell_matvec_plain."""
    if x.device.type == "cpu":
        return ell_matvec_plain(vals, cols, x)
    _check(x.is_cuda, f"unsupported device {x.device}")
    suffix = _float_suffix(x.dtype)
    _check(vals.dim() == 2 and cols.shape == vals.shape,
           f"vals and cols must be (w, n) alike, got {tuple(vals.shape)} and "
           f"{tuple(cols.shape)}")
    _check(x.dim() == 1, f"x must be 1-D, got {tuple(x.shape)}")
    _check(vals.dtype == x.dtype and vals.device == x.device,
           "vals must match x's dtype and device")
    _check(cols.dtype == torch.int32 and cols.device == x.device,
           "cols must be int32 on x's device")
    for t in (vals, cols, x):
        _check(t.is_contiguous(), "K3 inputs must be contiguous")
    w, n = vals.shape
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    _check(w == 0 or x.shape[0] > 0, "x is empty but the table has slots")
    from fem_tpu_torch import kernels_build

    fn = getattr(kernels_build.library(), f"ell_matvec_{suffix}")
    with torch.cuda.device(x.device):
        _launch("ell_matvec", fn, vals.data_ptr(), cols.data_ptr(),
                x.data_ptr(), out.data_ptr(), n, w, ell_lanes(w),
                torch.cuda.current_stream().cuda_stream)
    return out
