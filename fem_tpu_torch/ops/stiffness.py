"""Batched isoparametric element kernels: B-matrix, stiffness, stress.

Port of `fem_tpu.ops.stiffness` to torch: the reference's per-element hot
loops (FormElKE m_local.F90:21-67, CalcElStress m_local.F90:93-123, BMat
m_local.F90:148-171, FormdNdetJ m_local.F90:175-189) as one batched tensor
contraction per element type.

All batch-first functions take a leading element batch axis:
  ecoords: (ne, nn, pdim)   node coordinates gathered per element
  D:       (ne, cpdim, cpdim) per-element constitutive matrix
  ue:      (ne, nn*pdim)    element displacement vector (interleaved dofs)

The hex8 isotropic stiffness goes through `cuda_kernels.hex8_stiffness`
(kernel K1 on a CUDA tensor, differentiable there in lam and mu; its plain
torch form on a CPU tensor, differentiable in every input, as fem_tpu's is
under jax.grad, fem_tpu `tests/test_differentiable.py:17-59`).
"""

from __future__ import annotations

import torch

from fem_tpu_torch.ops import cuda_kernels
from fem_tpu_torch.ops.elements import ElementType
from fem_tpu_torch.utils import smallmat, timing


def _table(a, like):
    return timing.upload(a, dtype=like.dtype, device=like.device)


def grad_and_detj(et: ElementType, ecoords):
    """Spatial shape-function gradients and |J| at every integration point.

    Mirrors FormdNdetJ (m_local.F90:175-189): J = dN_xi @ X, detJ = |J|,
    dN_x = J^-1 dN_xi, batched over (ne, nip) with closed-form inverses.

    Returns:
      dNx:  (ne, nip, pdim, nn)
      detj: (ne, nip)
    """
    dN = _table(et.dN, ecoords)  # (nip, pdim, nn)
    jac = torch.einsum("ipn,end->eipd", dN, ecoords)  # (ne, nip, pdim, pdim)
    detj = smallmat.det(jac)
    invj = smallmat.inv(jac)
    dNx = torch.einsum("eipq,iqn->eipn", invj, dN)
    return dNx, detj


def bmat(dNx, pdim: int):
    """Strain-displacement matrix B from spatial gradients.

    Mirrors BMat (m_local.F90:148-171). dNx: (..., pdim, nn) ->
    B: (..., cpdim, nn*pdim) with dof ordering (node0_x, node0_y[, node0_z],
    node1_x, ...) to match FormElIndx (m_local.F90:70-78).
    """
    zero = torch.zeros_like(dNx[..., 0, :])
    if pdim == 2:
        dx, dy = dNx[..., 0, :], dNx[..., 1, :]
        rows = [
            torch.stack([dx, zero], dim=-1),
            torch.stack([zero, dy], dim=-1),
            torch.stack([dy, dx], dim=-1),
        ]
    elif pdim == 3:
        dx, dy, dz = dNx[..., 0, :], dNx[..., 1, :], dNx[..., 2, :]
        rows = [
            torch.stack([dx, zero, zero], dim=-1),
            torch.stack([zero, dy, zero], dim=-1),
            torch.stack([zero, zero, dz], dim=-1),
            torch.stack([dy, dx, zero], dim=-1),
            torch.stack([zero, dz, dy], dim=-1),
            torch.stack([dz, zero, dx], dim=-1),
        ]
    else:
        raise ValueError(f"bmat: pdim must be 2 or 3, got {pdim}")
    b = torch.stack(rows, dim=-3)  # (..., cpdim, nn, pdim)
    return b.reshape(b.shape[:-2] + (b.shape[-2] * b.shape[-1],))


def element_stiffness(et: ElementType, ecoords, D):
    """Batched element stiffness k_e = sum_ip B^T D B w detJ.

    Mirrors FormElKE (m_local.F90:21-67). Returns (ne, ndof, ndof).
    """
    dNx, detj = grad_and_detj(et, ecoords)
    B = bmat(dNx, et.pdim)  # (ne, nip, cpdim, ndof)
    scale = detj * _table(et.weights, ecoords)[None, :]  # (ne, nip)
    return torch.einsum("eica,ecd,eidb,ei->eab", B, D, B, scale)


def lame(E, nu):
    """Lame parameters from (E, nu)."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


def element_stiffness_isotropic(et: ElementType, ecoords, E, nu):
    """Element stiffness for isotropic elasticity (E, nu form); see
    element_stiffness_lame. Returns (ne, ndof, ndof)."""
    lam, mu = lame(E, nu)
    return element_stiffness_lame(et, ecoords, lam, mu)


def element_stiffness_lame(et: ElementType, ecoords, lam, mu):
    """Element stiffness from per-element Lame parameters (lam, mu: (ne,)).

    Factorized through the gradient-correlation tensor
      H[p,a,q,b] = sum_ip w detJ dNx[ip,p,a] dNx[ip,q,b]
      ke[(a,p),(b,q)] = lam H[p,a,q,b] + mu H[q,a,p,b]
                        + mu delta_pq sum_k H[k,a,k,b]
    which avoids forming B and D. ke is LINEAR in (lam, mu) — the basis of
    the structured-grid operator's k_lam/k_mu pair. hex8 goes through
    cuda_kernels.hex8_stiffness (kernel K1 on CUDA tensors).
    Returns (ne, ndof, ndof).
    """
    ne = ecoords.shape[0]
    if et.name == "hex":
        ke = cuda_kernels.hex8_stiffness(
            ecoords.permute(2, 1, 0).contiguous(), lam.contiguous(),
            mu.contiguous(),
        )  # (24, 24, ne)
        return ke.permute(2, 0, 1).contiguous()
    dNx, detj = grad_and_detj(et, ecoords)  # (ne, nip, pdim, nn)
    s = detj * _table(et.weights, ecoords)[None, :]
    H = torch.einsum("ei,eipa,eiqb->epaqb", s, dNx, dNx)
    term = (lam[:, None, None, None, None] * H
            + mu[:, None, None, None, None] * H.transpose(1, 3))
    ke = term.permute(0, 2, 1, 4, 3)  # (ne, a, p, b, q)
    trace = torch.einsum("ekakb->eab", H)
    eye = torch.eye(et.pdim, dtype=ecoords.dtype, device=ecoords.device)
    ke = ke + mu[:, None, None, None, None] * (
        trace[:, :, None, :, None] * eye[None, None, :, None, :]
    )
    return ke.reshape(ne, et.ndof, et.ndof)


def _det_inv_batchlast(J):
    """Closed-form det/inverse for J shaped (nip, d, d, ne) — element batch
    last."""
    Jm = J.permute(0, 3, 1, 2)  # (nip, ne, d, d)
    return smallmat.det(Jm), smallmat.inv(Jm).permute(0, 2, 3, 1)


def element_stiffness_lame_batchlast(et: ElementType, ecoords_l, lam, mu):
    """element_stiffness_lame with the element batch LAST.

    Takes ecoords_l: (pdim, nn, ne) and returns (nn, pdim, nn, pdim, ne) —
    the layout of kernel K1's output, whose plain form this is for hex8.
    """
    dN = _table(et.dN, ecoords_l)  # (nip, pdim, nn)
    w = _table(et.weights, ecoords_l)
    J = torch.einsum("ipa,dae->ipde", dN, ecoords_l)  # (nip, pdim, pdim, ne)
    det, inv = _det_inv_batchlast(J)
    dNx = torch.einsum("ipqe,iqa->ipae", inv, dN)  # (nip, pdim, nn, ne)
    s = det * w[:, None]
    # H[p,a,q,b,e] = sum_ip s dNx[ip,p,a] dNx[ip,q,b]
    H = torch.einsum("ie,ipae,iqbe->paqbe", s, dNx, dNx)
    term = lam * H + mu * H.permute(2, 1, 0, 3, 4)  # H[q,a,p,b]
    ke = term.permute(1, 0, 3, 2, 4)  # (a,p,b,q,e)
    tr = torch.einsum("kakbe->abe", H)
    eye = torch.eye(et.pdim, dtype=ecoords_l.dtype, device=ecoords_l.device)
    return ke + mu * tr[:, None, :, None, :] * eye[None, :, None, :, None]


def element_stress(et: ElementType, ecoords, ue, D):
    """Batched integration-point stress: eps = B u_e, sigma = D eps.

    Mirrors CalcElStress (m_local.F90:93-123). Returns (ne, nip, cpdim).
    """
    dNx, _ = grad_and_detj(et, ecoords)
    B = bmat(dNx, et.pdim)
    eps = torch.einsum("eica,ea->eic", B, ue)
    return torch.einsum("ecd,eid->eic", D, eps)


def nodal_stress(et: ElementType, sigma_ip):
    """Extrapolate integration-point stress to element nodes.

    Mirrors RecoverNodalStress (m_global.F90:488-515): multiply by the
    memoized N2^-1 when nip == nnodes, broadcast when nip == 1.
    sigma_ip: (ne, nip, cpdim) -> (ne, nnodes, cpdim).
    """
    if et.n2inv is not None:
        return torch.einsum("ni,eic->enc", _table(et.n2inv, sigma_ip), sigma_ip)
    if et.nip == 1:
        return sigma_ip.expand(sigma_ip.shape[0], et.nnodes, sigma_ip.shape[2])
    raise ValueError(
        f"nodal_stress: no extrapolation rule for {et.name} "
        f"(nip={et.nip}, nnodes={et.nnodes})"
    )


def element_dofs(et: ElementType, conn):
    """Interleaved dof indices per element (FormElIndx, m_local.F90:70-78).

    conn: (ne, nn) 0-based node ids -> (ne, nn*pdim) 0-based dof ids, ordered
    (n0_x, n0_y[, n0_z], n1_x, ...).
    """
    pdim = et.pdim
    offs = torch.arange(pdim, dtype=conn.dtype, device=conn.device)
    return (conn[..., None] * pdim + offs).reshape(conn.shape[0], et.nnodes * pdim)
