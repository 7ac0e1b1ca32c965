"""Hand-written Hopper kernels of the port, with their plain torch versions.

Counterpart of `fem_tpu/ops/pallas_kernels.py`. For each kernel this module
holds the plain torch version (what the CPU tests run and what the kernel is
checked against on the card), the wrapper, and a launch count.

  K1 hex8_stiffness   csrc/hex8_stiffness.cu  replaces hex8_stiffness_pallas
  K2 stencil_matvec   csrc/stencil_matvec.cu  replaces stencil_matvec_pallas
  K3 csr_matvec       csrc/csr_matvec.cu      replaces ell_matvec_pallas

K2 has a 2D branch, the 9-point form on (ny, nx) node grids with 2 DOFs a
node (its own entry point, counted as "stencil_matvec_2d"): the Pallas
kernel is 3D only, and fem_tpu computes 2D K.u in XLA.

and two backward kernels, of the gradients that jax.grad takes through
fem_tpu's jnp forms of K1 and K3 (its Pallas kernels have no backward):

  hex8_stiffness_coord_grad  csrc/hex8_stiffness.cu  K1 in the coordinates
  csr_data_grad              csrc/csr_matvec.cu      K3 in data

A wrapper given a CPU tensor returns the plain version. Given a CUDA tensor
it launches the kernel (built at first use by `fem_tpu_torch.kernels_build`)
on the current stream or raises; there is no fallback. On CUDA every kernel
is differentiable in each float input through an autograd Function whose
backward launches kernels only: K1 in (lam, mu) by two more K1 launches and
in the coordinates by hex8_stiffness_coord_grad, K2 in u by one more K2
launch, K3 in x by K3 on the transposed table and in data by
csr_data_grad. `launches[name]` is incremented once per kernel launch and
nowhere else. The wrappers sit on launch-bound solver loops, so their checks
format a message only when they fail.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fem_tpu_torch import kernels_build
from fem_tpu_torch.ops import elements
from fem_tpu_torch.utils import timing

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

launches = {"hex8_stiffness": 0, "hex8_stiffness_coord_grad": 0,
            "stencil_matvec": 0, "stencil_matvec_2d": 0, "csr_matvec": 0,
            "csr_data_grad": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(cond: bool, msg: str, *args) -> None:
    if not cond:
        raise ValueError(msg.format(*args))


def _launch(name: str, like, *args, key: str = "") -> None:
    """Launch C entry point `name_f64` or `name_f32` (by like's dtype) on
    the current stream of like's device; counted under `key` (default
    name)."""
    index = like.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, like, *args, key=key)
    fn = getattr(kernels_build.library(), f"{name}_{_float_suffix(like.dtype)}")
    # the private accessor skips the Stream object that
    # torch.cuda.current_stream builds, on paths that launch hundreds of
    # kernels per CG iteration
    err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[key or name] += 1


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


def _hex8_launch(ecoords_l, lam, mu):
    """One K1 launch on CUDA tensors: hex8_stiffness_plain's contract."""
    _check(ecoords_l.is_cuda, "unsupported device {}", ecoords_l.device)
    ne = ecoords_l.shape[-1] if ecoords_l.dim() == 3 else -1
    _check(ecoords_l.shape == (3, 8, ne), "ecoords_l must be (3, 8, ne), got "
           "{}", tuple(ecoords_l.shape))
    for name, t in (("lam", lam), ("mu", mu)):
        _check(t.shape == (ne,), "{} must be ({},), got {}", name, ne,
               tuple(t.shape))
        _check(t.dtype == ecoords_l.dtype and t.device == ecoords_l.device,
               "{} must match ecoords_l's dtype and device", name)
    for t in (ecoords_l, lam, mu):
        _check(t.is_contiguous(), "K1 inputs must be contiguous")
    out = torch.empty((24, 24, ne), dtype=ecoords_l.dtype,
                      device=ecoords_l.device)
    if ne == 0:
        return out
    _launch("hex8_stiffness", ecoords_l, ecoords_l.data_ptr(), lam.data_ptr(),
            mu.data_ptr(), out.data_ptr(), ne)
    return out


def hex8_stiffness_coord_grad_plain(ecoords_l, lam, mu, grad):
    """Plain form of K1's coordinate backward: d<grad, K1(x, lam, mu)>/dx,
    (3, 8, ne) for a (24, 24, ne) grad, by the kernel's contractions, not by
    autograd. At each Gauss point, with N = dNx (3, 8), dN the reference
    gradients, inv = J^-1, s = w detJ and Gs_ab the (3, 3) block of grad's
    symmetric part at nodes a, b (k_e is symmetric):

        M_ab       = lam Gs_ab + mu Gs_ab^T + mu tr(Gs_ab) I
        Nbar'[:,a] = 2 sum_b M_ab N[:,b]      dL/dN = s Nbar'
        C          = (Nbar' dN^T) inv^T       dL/ds = f = tr(C) / 2
        Jbar       = s inv^T (f I - C)        dL/dJ = Jbar
        dL/dx[d,a] = sum_p Jbar[p,d] dN[p,a]  summed over the points

    f is the point's term of L without s: L is quadratic in N."""
    from fem_tpu_torch.ops import stiffness  # stiffness imports this module

    et = elements.get("hex")
    dN = stiffness._table(et.dN, ecoords_l)  # (ip, 3, 8)
    w = stiffness._table(et.weights, ecoords_l)
    J = torch.einsum("ipa,dae->ipde", dN, ecoords_l)
    det, inv = stiffness._det_inv_batchlast(J)  # inv[ip, p, q, e]
    N = torch.einsum("ipqe,iqa->ipae", inv, dN)
    G = grad.reshape(8, 3, 8, 3, -1)
    Gs = 0.5 * (G + G.permute(2, 3, 0, 1, 4))  # [a, p, b, q, e]
    tr = torch.einsum("apbpe->abe", Gs)
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    M = (lam * Gs.permute(0, 2, 1, 3, 4) + mu * Gs.permute(0, 2, 3, 1, 4)
         + mu * tr[:, :, None, None] * eye[:, :, None])  # [a, b, x, q, e]
    nbar = 2 * torch.einsum("abxqe,iqbe->ixae", M, N)
    C = torch.einsum("ipae,iqa,irqe->ipre", nbar, dN, inv)
    f = 0.5 * torch.einsum("ippe->ie", C)
    Jbar = (det * w[:, None])[:, None, None] * (
        f[:, None, None] * inv.transpose(1, 2)
        - torch.einsum("irpe,irde->ipde", inv, C))
    return torch.einsum("ipde,ipa->dae", Jbar, dN)


def _hex8_coord_grad_launch(ecoords_l, lam, mu, grad):
    """One launch of K1's coordinate backward on CUDA tensors (the checked
    inputs of a K1 launch): hex8_stiffness_coord_grad_plain's contract."""
    ne = ecoords_l.shape[-1]
    _check(grad.shape == (24, 24, ne) and grad.dtype == ecoords_l.dtype
           and grad.device == ecoords_l.device and grad.is_contiguous(),
           "grad must be a contiguous (24, 24, {}) tensor like ecoords_l",
           ne)
    out = torch.empty_like(ecoords_l)
    if ne == 0:
        return out
    _launch("hex8_stiffness_coord_grad", ecoords_l, ecoords_l.data_ptr(),
            lam.data_ptr(), mu.data_ptr(), grad.data_ptr(), out.data_ptr(),
            ne)
    return out


class _Hex8Stiffness(torch.autograd.Function):
    """K1 with autograd in every input. k_e is linear in (lam, mu) per
    element, so with G the gradient of the output,
    grad_lam[e] = sum G[:, :, e] * K1(x, 1, 0)[:, :, e] and grad_mu likewise
    with K1(x, 0, 1): one more K1 launch and one reduction for each. The
    gradient in the coordinates is one launch of its own kernel."""

    @staticmethod
    def forward(ctx, ecoords_l, lam, mu):
        ctx.save_for_backward(ecoords_l, lam, mu)
        return _hex8_launch(ecoords_l, lam, mu)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, lam, mu = ctx.saved_tensors
        grad = grad.contiguous()
        g_x = g_lam = g_mu = None
        if ctx.needs_input_grad[0]:
            g_x = _hex8_coord_grad_launch(x, lam, mu, grad)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            one = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
            zero = torch.zeros_like(one)
            if ctx.needs_input_grad[1]:
                g_lam = (grad * _hex8_launch(x, one, zero)).sum((0, 1))
            if ctx.needs_input_grad[2]:
                g_mu = (grad * _hex8_launch(x, zero, one)).sum((0, 1))
        return g_x, g_lam, g_mu


def hex8_stiffness(ecoords_l, lam, mu):
    """K1 wrapper: same contract as hex8_stiffness_plain. On CUDA tensors
    it is differentiable in every input through _Hex8Stiffness, whose
    backward launches kernels only. On CPU tensors it is the plain form,
    differentiable in every input by autograd."""
    if ecoords_l.device.type == "cpu":
        return hex8_stiffness_plain(ecoords_l, lam, mu)
    return _Hex8Stiffness.apply(ecoords_l, lam, mu)


# --------------------------------------------------------------------------
# K2: structured-grid stencil matvec
# --------------------------------------------------------------------------


def _cell_mask(shape, off, like):
    """Float indicator over the node grid: 1 where the cell at node - off
    exists (0 <= node - off <= n - 2 on every axis). Built on like's device:
    no host-to-device copy."""
    mask = None
    for ax, n in enumerate(shape):
        x = torch.arange(n, device=like.device) - off[ax]
        m_shape = [1] * len(shape)
        m_shape[ax] = n
        m = ((x >= 0) & (x <= n - 2)).to(like.dtype).reshape(m_shape)
        mask = m if mask is None else mask * m
    return mask


def stencil_matvec_plain(k_ref, u, shape):
    """The per-corner masked form of K.u (the semantics of fem_tpu's
    structured._planes_core) for 2D or 3D node grids:

        out_p[n] = sum_a M_a[n] sum_{b,q} k[a,p,b,q] u_q[n - off_a + off_b]

    k_ref: (nn*pdim, nn*pdim) scalar-material element stiffness; u: (ndof,)
    node-interleaved over the node grid `shape`; returns (ndof,). Each shifted
    read is a slice of a zero-padded component-planes tensor; M_a masks the
    corners whose cell does not exist. The reference K2 is held against in
    both dimensions; no solver path calls it.
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


def stencil_offsets(pdim: int):
    """The 3^pdim node offsets o of the collapsed stencil, in the order
    o = sum over axes of (o_ax + 1) 3^(pdim - 1 - ax) (fem_tpu's
    structured._pair_tables order): 27 in 3D, 9 in 2D."""
    return tuple(itertools.product((-1, 0, 1), repeat=pdim))


STENCIL_OFFSETS = stencil_offsets(3)


@dataclasses.dataclass(frozen=True)
class StencilTables:
    """What K2 reads for one operator on a 3D or a 2D node grid: coef[c, o,
    p, q] for the 3^pdim node classes c (on each axis 0 at the first node, 2
    at the last, 1 between; c = 9 cx + 3 cy + cz in 3D, 3 c0 + c1 in 2D) and
    the 3^pdim offsets o of stencil_offsets, such that

        out_p[n] = sum_{o, q} coef[class(n), o, p, q] u_q[n + o].

    coef[centre] (centre = 13 in 3D, 4 in 2D) is the interior stencil;
    `interior` is a copy of it on the CPU, which the kernel takes by value."""

    coef: torch.Tensor  # (27, 27, 3, 3) or (9, 9, 2, 2), operator's device
    interior: torch.Tensor  # (243,) or (36,): coef[centre] on the CPU
    shape: Tuple[int, ...]

    @property
    def centre(self) -> int:
        return self.coef.shape[0] // 2


def stencil_tables(k_ref, shape) -> StencilTables:
    """K2's tables for a scalar-material k_ref ((24, 24) in 3D, (8, 8) in
    2D) on the node grid `shape`, built in float64 on the CPU and stored in
    k_ref's dtype on its device. The cell at node - off_a exists, along one
    axis, for both corner bits at an interior node, for bit 0 only at the
    first node and bit 1 only at the last; an axis of one node has no cell.
    So a class's coefficient for offset o sums k[a, p, b, q] over the
    corners a whose cell exists there, b the corner at off_a + o (fem_tpu's
    csum for the interior class)."""
    shape = tuple(int(n) for n in shape)
    pdim = len(shape)
    offs = HEX_OFFSETS if pdim == 3 else QUAD_OFFSETS
    nn, nc = len(offs), 3 ** pdim
    k = k_ref.detach().to("cpu", torch.float64).reshape(nn, pdim, nn, pdim)
    # [axis][class, corner bit]: does the cell at node - bit exist
    masks = [torch.tensor([[float(n >= 2), 0.0], [1.0, 1.0], [0.0, 1.0]],
                          dtype=torch.float64) for n in shape]
    coef = torch.zeros((nc, nc, pdim, pdim), dtype=torch.float64)
    for a, oa in enumerate(offs):
        m = masks[0][:, oa[0]]
        for ax in range(1, pdim):
            m = torch.outer(m, masks[ax][:, oa[ax]]).reshape(-1)
        for b, ob in enumerate(offs):
            o = 0
            for x, y in zip(oa, ob):
                o = 3 * o + y - x + 1
            coef[:, o] += m[:, None, None] * k[a, :, b, :]
    coef = coef.to(k_ref.dtype)
    return StencilTables(coef=timing.upload(coef, device=k_ref.device),
                         interior=coef[nc // 2].reshape(-1).contiguous(),
                         shape=shape)


def _node_classes(shape, device):
    """(*shape) long tensor of the node classes of StencilTables."""
    out = None
    for ax, n in enumerate(shape):
        c = torch.ones(n, dtype=torch.long, device=device)
        c[0] = 0
        if n >= 2:
            c[-1] = 2
        c = c.reshape([n if i == ax else 1 for i in range(len(shape))])
        out = c if out is None else 3 * out + c
    return out


def _collapsed_plain(t: StencilTables, u):
    """The interior row of the tables applied to every node, one shifted
    copy of the zero-padded u at a time; then the boundary nodes recomputed
    from their 3^pdim gathered neighbours with their class's row. u: (ndof,)
    node-interleaved over t.shape; returns (ndof,)."""
    shape = t.shape
    pdim = len(shape)
    offsets = stencil_offsets(pdim)
    U = F.pad(u.reshape(*shape, pdim).movedim(-1, 0), [1, 1] * pdim)
    out = None
    for o, off in enumerate(offsets):
        term = torch.tensordot(t.coef[t.centre, o], U[(slice(None),) + tuple(
            slice(1 + d, 1 + d + n) for d, n in zip(off, shape))], dims=1)
        out = term if out is None else out.add_(term)
    cls = _node_classes(shape, u.device).reshape(-1)
    bnd = torch.nonzero(cls != t.centre).squeeze(1)
    # flat indices of the boundary nodes' neighbours in the padded grid
    base = torch.zeros_like(bnd)
    strides = []
    for ax in range(pdim):
        inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
        base = base * (shape[ax] + 2) + bnd // inner % shape[ax] + 1
        strides.append(int(np.prod([n + 2 for n in shape[ax + 1:]],
                                   dtype=np.int64)))
    delta = torch.tensor([sum(d * s for d, s in zip(off, strides))
                          for off in offsets], device=u.device)
    nbr = U.reshape(pdim, -1)[:, base[:, None] + delta]  # (pdim, bnd, 3^pdim)
    # every class's row at these nodes, then each node's own class
    rows = torch.einsum("copq,qbo->bcp", t.coef, nbr)
    out = out.reshape(pdim, -1)
    out[:, bnd] = rows[torch.arange(bnd.shape[0], device=u.device),
                       cls[bnd]].T
    return out.T.reshape(-1)


def stencil27_plain(t: StencilTables, u):
    """Plain form of K2 on a 3D node grid (the collapsed 27-point stencil
    with its boundary classes)."""
    _check(len(t.shape) == 3, "stencil27_plain takes 3D tables")
    return _collapsed_plain(t, u)


def stencil9_plain(t: StencilTables, u):
    """Plain form of K2's 2D branch on a (ny, nx) node grid (the collapsed
    9-point stencil with its boundary classes, fem_tpu's
    structured.matvec_planes27 in 2D); the CPU path of 2D grids."""
    _check(len(t.shape) == 2, "stencil9_plain takes 2D tables")
    return _collapsed_plain(t, u)


def _k2_launch(t: StencilTables, u):
    """One K2 launch on a CUDA u: stencil27_plain's contract on a 3D grid,
    stencil9_plain's on a 2D one (its own entry point and launch count)."""
    pdim = len(t.shape)
    n = int(np.prod(t.shape)) * pdim
    _check(u.dim() == 1 and u.shape[0] == n and u.is_contiguous(),
           "u must be a contiguous ({},) vector, got {}", n, tuple(u.shape))
    _check(t.coef.dtype == u.dtype == t.interior.dtype
           and t.coef.get_device() == u.get_device()
           and not t.interior.is_cuda,
           "the tables must match u's dtype and device")
    out = torch.empty_like(u)
    if pdim == 3:
        _launch("stencil_matvec", u, t.interior.data_ptr(), t.coef.data_ptr(),
                u.data_ptr(), out.data_ptr(), *t.shape)
    else:
        _launch("stencil_matvec2d", u, t.interior.data_ptr(),
                t.coef.data_ptr(), u.data_ptr(), out.data_ptr(), *t.shape,
                key="stencil_matvec_2d")
    return out


class _StencilMatvec(torch.autograd.Function):
    """K2 with autograd in u. The assembled K is symmetric, so the gradient
    of <G, K u> with respect to u is K G: one more K2 launch. The tables are
    constants (stencil_tables detaches k_ref), as in the plain form."""

    @staticmethod
    def forward(ctx, t, u):
        ctx.tables = t
        return _k2_launch(t, u)

    @staticmethod
    def backward(ctx, grad):
        return None, _StencilMatvec.apply(ctx.tables, grad.contiguous())


def stencil_matvec(t: StencilTables, u):
    """K2 wrapper for 3D and 2D node grids: same contract as stencil27_plain
    or stencil9_plain (by len(t.shape)). On a CUDA u that requires grad it
    is differentiable in u (_StencilMatvec); the solver loops, which take no
    gradient, launch K2 directly."""
    if not u.is_cuda:
        _check(u.device.type == "cpu", "unsupported device {}", u.device)
        return _collapsed_plain(t, u)
    if u.requires_grad and torch.is_grad_enabled():
        return _StencilMatvec.apply(t, u)
    return _k2_launch(t, u)


# --------------------------------------------------------------------------
# K3: CSR sparse matrix-vector product
# --------------------------------------------------------------------------


def csr_lanes(n_rows: int, nnz: int) -> int:
    """Threads sharing one row in K3: the smallest power of two that is at
    least half the mean row length, at most 32 (on the H100, 8 for the
    55^3 SA-AMG prolongation's ~15 nonzeros per row, 32 for the restriction
    and the assembled operator)."""
    mean = nnz / max(n_rows, 1)
    lanes = 1
    while lanes < 32 and 2 * lanes < mean:
        lanes *= 2
    return lanes


def _csr_rows(indptr, dtype=torch.int64):
    """(nnz,) the row of each nonzero of a CSR table."""
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, dtype=dtype, device=indptr.device), indptr.diff())


def csr_matvec_plain(indptr, indices, data, x):
    """Plain form of K3: out[i] = sum_k data[k] * x[indices[k]] over
    indptr[i] <= k < indptr[i + 1]. indptr: (n + 1,) int64, indices: (nnz,)
    int32, data: (nnz,) float, x: (ncols,) -> (n,)."""
    return torch.zeros(indptr.shape[0] - 1, dtype=x.dtype,
                       device=x.device).index_add_(0, _csr_rows(indptr),
                                                   data * x[indices])


def csr_data_grad_plain(indptr, indices, x, gy):
    """Plain form of K3's backward in data: out[k] = gy[i] * x[indices[k]]
    over indptr[i] <= k < indptr[i + 1]; (nnz,)."""
    return gy[_csr_rows(indptr)] * x[indices]


def csr_transpose(indptr, indices, data, ncols: int):
    """(indptr, indices, data, lanes) of the transposed table, on the
    table's device: a stable sort of the nonzeros by column keeps each
    column's rows in order. data is taken as a constant."""
    with torch.no_grad():
        order = torch.sort(indices, stable=True).indices
        counts = torch.bincount(indices.long(), minlength=ncols)
        return (F.pad(torch.cumsum(counts, 0), (1, 0)),
                _csr_rows(indptr, torch.int32)[order],
                data[order].contiguous(), csr_lanes(ncols, data.shape[0]))


def _k3_launch(indptr, indices, data, x, lanes):
    """One K3 launch on CUDA tensors: csr_matvec_plain's contract."""
    index = x.get_device()
    _check(x.dim() == 1 and data.dtype == x.dtype
           and data.get_device() == index,
           "x must be 1-D and data must match its dtype and device")
    _check(indptr.dtype == torch.int64 and indptr.dim() == 1
           and indices.dtype == torch.int32 and indices.shape == data.shape
           and indptr.get_device() == index == indices.get_device(),
           "indptr must be int64 and indices int32 on x's device, indices "
           "like data")
    _check(x.is_contiguous() and data.is_contiguous()
           and indices.is_contiguous() and indptr.is_contiguous(),
           "K3 inputs must be contiguous")
    _check(lanes in (1, 2, 4, 8, 16, 32), "lanes must be a power of two "
           "<= 32, got {}", lanes)
    n = indptr.shape[0] - 1
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    _launch("csr_matvec", x, indptr.data_ptr(), indices.data_ptr(),
            data.data_ptr(), x.data_ptr(), out.data_ptr(), n, lanes)
    return out


def _csr_data_grad_launch(indptr, indices, x, gy, lanes):
    """One launch of K3's backward in data on the checked inputs of a K3
    launch and a contiguous (n,) gy: csr_data_grad_plain's contract."""
    _check(gy.shape == (indptr.shape[0] - 1,) and gy.dtype == x.dtype
           and gy.device == x.device and gy.is_contiguous(),
           "gy must be a contiguous ({},) vector like x",
           indptr.shape[0] - 1)
    out = torch.empty(indices.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("csr_data_grad", x, indptr.data_ptr(), indices.data_ptr(),
            x.data_ptr(), gy.data_ptr(), out.data_ptr(), gy.shape[0], lanes)
    return out


class _CsrMatvec(torch.autograd.Function):
    """K3 with autograd in data and x. For out = A x, the gradient in x is
    A^T gy: one K3 launch on the transposed table, which `transpose`
    returns (the table keeps it: amg.Csr.transposed). The gradient in data
    is gy[row(k)] * x[indices[k]]: one csr_data_grad launch."""

    @staticmethod
    def forward(ctx, indptr, indices, data, x, lanes, transpose):
        ctx.save_for_backward(indptr, indices, data, x)
        ctx.lanes, ctx.transpose = lanes, transpose
        return _k3_launch(indptr, indices, data, x, lanes)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        indptr, indices, data, x = ctx.saved_tensors
        grad = grad.contiguous()
        g_data = g_x = None
        if ctx.needs_input_grad[2]:
            g_data = _csr_data_grad_launch(indptr, indices, x, grad,
                                           ctx.lanes)
        if ctx.needs_input_grad[3]:
            t = ctx.transpose()
            g_x = _k3_launch(t.indptr, t.indices, t.data, grad, t.lanes)
        return None, None, g_data, g_x, None, None


def csr_matvec(indptr, indices, data, x, lanes: int, transpose):
    """K3 wrapper: same contract as csr_matvec_plain; `lanes` threads share a
    row (csr_lanes). On CUDA tensors it is differentiable in data and x
    through _CsrMatvec, whose backward launches kernels only; `transpose`
    is a callable that returns the transposed table (indptr, indices, data
    and lanes attributes; amg.Csr.transposed, which forms it once and keeps
    it). Without an input that requires grad, or with grad mode off, K3 is
    launched directly: no tensor is saved. On CPU tensors it is the plain
    form, differentiable in data and x by autograd."""
    if not x.is_cuda:
        _check(x.device.type == "cpu", "unsupported device {}", x.device)
        return csr_matvec_plain(indptr, indices, data, x)
    if torch.is_grad_enabled() and (x.requires_grad or data.requires_grad):
        return _CsrMatvec.apply(indptr, indices, data, x, lanes, transpose)
    return _k3_launch(indptr, indices, data, x, lanes)
