"""The power-law creep of defmod's viscoelastic material (`m_local.F90`
Matbeta / Matbetad, 3D), in plain torch.

Material columns 3 and 4 are the viscosity eta and the exponent n. With the
equivalent stress kappa = sqrt(((s1-s2)^2 + (s2-s3)^2 + (s1-s3)^2) / 6
+ s4^2 + s5^2 + s6^2), the creep strain rate is
    beta = kappa^(n-1) / (4 eta) * (2 dev(sigma), 4 tau),
and its derivative
    dbeta/dsigma = kappa^(n-1) / (4 eta) * (C + v v^T),
C the constant part, v = sqrt(n-1) (dev(sigma), 2 tau) / kappa; both are 0
where kappa = 0. One load step, from the Gauss-point stress sigma at its
start: D_eff = (D^-1 + dt dbeta/dsigma)^-1, the load gains
sum_ip B^T D_eff dt beta w det J, and after the solve
sigma += D_eff (B du - dt beta).
"""

from __future__ import annotations

import torch

_C = [[4 / 3, -2 / 3, -2 / 3, 0, 0, 0],
      [-2 / 3, 4 / 3, -2 / 3, 0, 0, 0],
      [-2 / 3, -2 / 3, 4 / 3, 0, 0, 0],
      [0, 0, 0, 4, 0, 0],
      [0, 0, 0, 0, 4, 0],
      [0, 0, 0, 0, 0, 4]]


def rate_and_slope(sigma, eta, n):
    """beta (..., 6) and dbeta/dsigma (..., 6, 6) at the stresses sigma."""
    normal, shear = sigma[..., :3], sigma[..., 3:]
    dev = normal - normal.mean(dim=-1, keepdim=True)
    s1, s2, s3 = normal.unbind(-1)
    kappa = torch.sqrt(((s1 - s2) ** 2 + (s2 - s3) ** 2 + (s1 - s3) ** 2)
                       / 6.0 + (shear ** 2).sum(-1))
    zero = kappa == 0
    k = torch.where(zero, torch.ones_like(kappa), kappa)
    scale = torch.where(zero, torch.zeros_like(k),
                        k ** (n - 1.0) / (4.0 * eta))
    beta = scale[..., None] * torch.cat([2.0 * dev, 4.0 * shear], dim=-1)
    v = (n - 1.0) ** 0.5 * torch.cat([dev, 2.0 * shear], dim=-1) / k[..., None]
    C = torch.tensor(_C, dtype=sigma.dtype, device=sigma.device)
    slope = scale[..., None, None] * (C + v[..., :, None] * v[..., None, :])
    return beta, slope


def step_terms(mesh, sigma, eta, n, dt):
    """Per block of elements: D_eff, dt * beta, and the creep load of the
    step, from the Gauss-point stresses sigma (ne, nip, 6) at its start.
    Returns (D_eff, dt_beta, load)."""
    S = torch.linalg.inv(mesh.D)
    beta, slope = rate_and_slope(sigma, eta, n)
    D_eff = torch.linalg.inv(S + dt * slope)
    dt_beta = dt * beta
    load = torch.zeros(mesh.ndof, dtype=sigma.dtype, device=sigma.device)
    for sl in mesh.chunks():
        B, wdet = mesh.geometry(sl)
        g = torch.einsum("eicd,eid->eic", D_eff[sl], dt_beta[sl])
        fe = torch.einsum("eica,eic,ei->ea", B, g, wdet)
        load.index_add_(0, mesh.edofs[sl].reshape(-1), fe.reshape(-1))
    return D_eff, dt_beta, load


def update(mesh, sigma, du, D_eff, dt_beta):
    """sigma + D_eff (B du - dt beta) at every Gauss point."""
    out = torch.empty_like(sigma)
    for sl in mesh.chunks():
        eps = mesh.ip_strain(du, sl)
        out[sl] = sigma[sl] + torch.einsum("eicd,eid->eic", D_eff[sl],
                                           eps - dt_beta[sl])
    return out
