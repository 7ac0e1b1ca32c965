"""Cohesive (4-node, 2D) element math: the Xu-Needleman separation law.

Port of `fem_tpu.ops.cohesive`. Replaces the reference's cohesive pipeline —
getCohValues/getCohRels/getCohGaps (m_elems.F90:658-720),
Seplaw_1_Tract/Seplaw_1_Stiff (m_seplaw.F90:15-94), and the element force and
stiffness assembly applyTract_1/applyStiff_1 (m_global.F90:622-845) — with
batched tensor products.

Conventions (those of the reference source):
  - The element's 4 nodes are two paired edges; nodes (1,2) are the "bottom"
    face, (3,4) the "top", with N3=N2, N4=N1 (m_elems.F90:642-645).
  - gap[0] is the NORMAL separation, gap[1] the TANGENTIAL separation
    (getCohGaps m_elems.F90:714-718); Seplaw props are
    (sigma_max, delta_n, delta_t, q, r, zeta) (m_seplaw.F90:19-24).
  - Nodal force sign: + for bottom nodes, - for top (m_global.F90:664-666).

Known reference defects, reproduced with `quirks=True` (the default is the
corrected physics, which matches the Abaqus UEL of the reference's own
cross-validation):
  1. applyTract_1 *overwrites* `result` per integration point instead of
     accumulating (m_global.F90:669), so only the last ip contributes.
  2. applyStiff_1's update (m_global.F90:829-831) drops the
     sig1*sig2*N*N*w*det scaling on the normal-column term through Fortran
     operator precedence (`a + b*scale` instead of `(a + b)*scale`).

Batched shapes:
  ecoords: (ne, 4, 2)   props: (ne, 6)   ue: (ne, 8) interleaved local dofs
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fem_tpu_torch.ops.elements import get as get_element
from fem_tpu_torch.utils import timing

_COH = get_element("coh")
# Pairing sign per node: urel = sum_a sign[a] * N[ip,a] * u[a] reproduces
# getCohRels' (top - bottom) relative displacement (m_elems.F90:697-704).
_PAIR_SIGN = np.array([-1.0, -1.0, 1.0, 1.0])
# Nodal force sign: + bottom, - top (m_global.F90:664-666).
_FORCE_SIGN = np.array([1.0, 1.0, -1.0, -1.0])


def _const(a, like):
    return timing.upload(a, dtype=like.dtype, device=like.device)


def geometry(ecoords):
    """Midplane tangent, normal and half-length (getCohValues
    m_elems.F90:658-673): (ne, 4, 2) -> tangent (ne, 2) unit, normal (ne, 2)
    unit, det (ne,)."""
    tvec = 0.5 * (ecoords[:, 1, :] - ecoords[:, 0, :] + ecoords[:, 2, :]
                  - ecoords[:, 3, :])
    length = torch.sqrt(torch.sum(tvec * tvec, dim=-1))
    tangent = tvec / length[:, None]
    normal = torch.stack([-tangent[:, 1], tangent[:, 0]], dim=-1)
    return tangent, normal, 0.5 * length


def gaps(ecoords, ue, dt):
    """Normal/tangential gap and gap rate at each integration point
    (getCohRels, vrel = urel/dt, m_elems.F90:705, and getCohGaps
    m_elems.F90:709-720). Returns (gap_n, gap_t, vgap_n, vgap_t), each
    (ne, nip), and the geometry (tangent, normal, det)."""
    tangent, normal, det = geometry(ecoords)
    N = _const(_COH.N, ue)  # (nip, 4)
    sign = _const(_PAIR_SIGN, ue)
    u_nodes = ue.reshape(ue.shape[0], 4, 2)
    urel = torch.einsum("ia,a,ead->eid", N, sign, u_nodes)  # (ne, nip, 2)
    gap_n = torch.einsum("ed,eid->ei", normal, urel)
    gap_t = torch.einsum("ed,eid->ei", tangent, urel)
    return gap_n, gap_t, gap_n / dt, gap_t / dt, tangent, normal, det


def xu_needleman_traction(props, gap_n, gap_t, vgap_n):
    """Xu-Needleman traction with Gao-Bower viscous regularization
    (Seplaw_1_Tract m_seplaw.F90:15-53). props (..., 6) =
    (sigma_max, delta_n, delta_t, q, r, zeta); gaps broadcast against props.
    Returns (T_n, T_t)."""
    sigma_max, dn, dtt, q, r, zeta = props.unbind(-1)
    sepwrk = math.e * sigma_max * dn
    en = torch.exp(-gap_n / dn)
    et = torch.exp(-(gap_t * gap_t) / (dtt * dtt))
    # T_n (m_seplaw.F90:43-46) + viscous term (m_seplaw.F90:52)
    c1 = (1.0 - et) * (1.0 - q) / (r - 1.0) * (r - gap_n / dn)
    c2 = (gap_n / dn) * et
    t_n = (sepwrk / dn) * en * (c2 + c1) + zeta * sigma_max * vgap_n / dn
    # T_t (m_seplaw.F90:48-51)
    c3 = (q + (r - q) / (r - 1.0) * (gap_n / dn)) * en * et
    t_t = 2.0 * (dn / dtt) * (sepwrk / dn) * c3 * gap_t / dtt
    return t_n, t_t


def xu_needleman_stiffness(props, gap_n, gap_t, dt):
    """Analytic tangent d(T)/d(gap), 2x2 per point (Seplaw_1_Stiff
    m_seplaw.F90:57-94). Returns (k_nn, k_tt, k_nt), k_tn == k_nt; k_nn
    carries the viscous term zeta*sigma_max/(dn*dt) (m_seplaw.F90:92)."""
    sigma_max, dn, dtt, q, r, zeta = props.unbind(-1)
    sepwrk = math.e * sigma_max * dn
    en = torch.exp(-gap_n / dn)
    et = torch.exp(-(gap_t * gap_t) / (dtt * dtt))
    c1 = (1.0 - q) / (r - 1.0) * (1.0 - et) * (r + 1.0 - gap_n / dn)
    k_nn = (sepwrk / (dn * dn)) * en * ((1.0 - gap_n / dn) * et - c1)
    k_nn = k_nn + zeta * sigma_max / dn / dt
    c2 = (q + (gap_n / dn) * (r - q) / (r - 1.0)) * en * et
    k_tt = 2.0 * (sepwrk / (dtt * dtt)) * c2 * (
        1.0 - 2.0 * gap_t * gap_t / (dtt * dtt))
    c3 = (-gap_n / dn + (1.0 - q) / (r - 1.0) * (r - gap_n / dn)) * en * et
    k_nt = (gap_t / dtt) * 2.0 * (sepwrk / (dtt * dn)) * c3
    return k_nn, k_tt, k_nt


def element_force(ecoords, props, ue, dt, quirks: bool = False):
    """Batched cohesive nodal force vector (applyTract_1
    m_global.F90:622-682). Returns (ne, 8):
    f[(a,d)] = sign_a N[ip,a] (T_n n_d + T_t t_d) w det summed over ips (or,
    with quirks=True, the reference's last-ip overwrite)."""
    gap_n, gap_t, vgap_n, _, tangent, normal, det = gaps(ecoords, ue, dt)
    t_n, t_t = xu_needleman_traction(props[:, None, :], gap_n, gap_t, vgap_n)
    traction = (t_n[..., None] * normal[:, None, :]
                + t_t[..., None] * tangent[:, None, :])  # (ne, nip, 2)
    N = _const(_COH.N, ue)
    w = _const(_COH.weights, ue)
    fsign = _const(_FORCE_SIGN, ue)
    # per-ip contribution (ne, nip, 4 nodes, 2 dofs)
    contrib = (fsign[None, None, :, None] * N[None, :, :, None]
               * traction[:, :, None, :]
               * (w[None, :] * det[:, None])[:, :, None, None])
    f = contrib[:, -1] if quirks else contrib.sum(dim=1)
    return f.reshape(ue.shape[0], 8)


def element_stiffness(ecoords, props, ue, dt, quirks: bool = False):
    """Batched cohesive tangent stiffness (applyStiff_1
    m_global.F90:762-845), (ne, 8, 8). The correct form (the Abaqus UEL's,
    and -d(element_force)/d(ue)):
      ke[(a,d1),(b,d2)] = sum_ip sign_a sign_b N_a N_b w det *
          [ n_d1 (k_nn n_d2 + k_nt t_d2) + t_d1 (k_tn n_d2 + k_tt t_d2) ]
    With quirks=True the normal-column term is added unscaled, as the
    reference's precedence defect does (m_global.F90:829-831)."""
    gap_n, gap_t, _, _, tangent, normal, det = gaps(ecoords, ue, dt)
    k_nn, k_tt, k_nt = xu_needleman_stiffness(props[:, None, :], gap_n, gap_t,
                                              dt)
    n_ = normal[:, None, :]  # (ne, 1, 2), broadcast over ips
    t_ = tangent[:, None, :]
    col_n = k_nn[..., None] * n_ + k_nt[..., None] * t_  # (ne, nip, 2)
    col_t = k_nt[..., None] * n_ + k_tt[..., None] * t_
    N = _const(_COH.N, ue)
    w = _const(_COH.weights, ue)
    fsign = _const(_FORCE_SIGN, ue)
    # scale[e,ip,a,b] = sign_a sign_b N_a N_b w det
    sn = fsign[None, :] * N  # (nip, 4)
    scale = ((sn[:, :, None] * sn[:, None, :])[None]
             * (w[None, :] * det[:, None])[:, :, None, None])
    if quirks:
        # result += term_n + term_t*scale: the ROW (dof1) carries the
        # k-column combination and the COLUMN (dof2) carries n/t, as in the
        # Fortran; term_n is the raw, unscaled normal-column product
        term_n = col_n[..., :, None] * n_[..., None, :]  # (ne, nip, 2, 2)
        term_t = col_t[..., :, None] * t_[..., None, :]
        ke = (term_n.sum(dim=1)[:, None, None, :, :].expand(-1, 4, 4, -1, -1)
              + torch.einsum("eiab,eipq->eabpq", scale, term_t))
    else:
        rot = (n_[..., :, None] * col_n[..., None, :]
               + t_[..., :, None] * col_t[..., None, :])
        ke = torch.einsum("eiab,eipq->eabpq", scale, rot)
    # (ne, 4, 4, 2, 2) -> (ne, 8, 8), dof-major within node
    return ke.permute(0, 1, 3, 2, 4).reshape(ue.shape[0], 8, 8)


def element_stiffness_ad(ecoords, props, ue, dt):
    """The tangent as -d(element_force)/d(ue) by forward-mode AD: a check of
    the analytic form (tests only). element_force is added to the external
    side of the residual (R = J du - F_ext - F_coh, m_global.F90:186-226), so
    the Jacobian takes the internal-force tangent, its negative."""

    def f(u1, ec, pr):
        return element_force(ec[None], pr[None], u1[None], dt)[0]

    return -torch.func.vmap(torch.func.jacfwd(f))(ue, ecoords, props)
