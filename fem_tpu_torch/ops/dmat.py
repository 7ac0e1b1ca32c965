"""Constitutive models: isotropic linear elasticity and power-law creep, in
torch.

Port of `fem_tpu/ops/dmat.py`: DMat2d/DMat3d (m_local.F90:204-228) and the
viscoelastic Matbeta/Matbetad family (m_local.F90:231-314; fem_tpu
`ops/dmat.py:68-180`). All functions are batched over leading axes.
"""

from __future__ import annotations

import torch

from fem_tpu_torch.utils import timing


def dmat2d(E, nu):
    """Plane-strain isotropic 3x3 D matrix (m_local.F90:212-218).

    c = E/((1+nu)(1-2nu)); rows/cols ordered (xx, yy, xy).
    E and nu are tensors of one shape (...,); returns (...,3,3).
    """
    c = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    d = torch.stack(
        [
            torch.stack([(one - nu), nu, zero], dim=-1),
            torch.stack([nu, (one - nu), zero], dim=-1),
            torch.stack([zero, zero, (one - 2.0 * nu) / 2.0], dim=-1),
        ],
        dim=-2,
    )
    return c[..., None, None] * d


def dmat3d(E, nu):
    """3D isotropic 6x6 D matrix (m_local.F90:221-228).

    Component order (xx, yy, zz, xy, yz, zx) to match BMat's 3D row order
    (m_local.F90:161-169).
    """
    c = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    g = (one - 2.0 * nu) / 2.0
    a = one - nu
    rows = [
        torch.stack([a, nu, nu, zero, zero, zero], dim=-1),
        torch.stack([nu, a, nu, zero, zero, zero], dim=-1),
        torch.stack([nu, nu, a, zero, zero, zero], dim=-1),
        torch.stack([zero, zero, zero, g, zero, zero], dim=-1),
        torch.stack([zero, zero, zero, zero, g, zero], dim=-1),
        torch.stack([zero, zero, zero, zero, zero, g], dim=-1),
    ]
    return c[..., None, None] * torch.stack(rows, dim=-2)


def dmat(E, nu, pdim: int):
    """Dispatch on spatial dimension (m_local.F90:204-209)."""
    if pdim == 2:
        return dmat2d(E, nu)
    if pdim == 3:
        return dmat3d(E, nu)
    raise ValueError(f"dmat: pdim must be 2 or 3, got {pdim}")


def _creep_scale(kappa, visc, expn):
    """kappa^(n-1) / (4 visc), the power law's scalar factor."""
    return kappa ** (expn - 1.0) / (4.0 * visc)


def creep_beta2d(stress, visc, expn):
    """Power-law creep strain rate beta(sigma), 2D (m_local.F90:239-246).

    stress: (..., 3) (xx, yy, xy); visc and expn broadcast against its
    leading axes. Returns (..., 3):
    kappa = sqrt(((s1-s2)/2)^2 + s3^2); beta = kappa^(n-1)/(4 visc) C sigma.
    """
    s1, s2, s3 = stress.unbind(-1)
    kappa = torch.sqrt(((s1 - s2) / 2.0) ** 2 + s3 ** 2)
    c_sigma = torch.stack([s1 - s2, s2 - s1, 4.0 * s3], dim=-1)
    return _creep_scale(kappa, visc, expn)[..., None] * c_sigma


def _kappa3d(stress):
    s1, s2, s3, s4, s5, s6 = stress.unbind(-1)
    return torch.sqrt(((s1 - s2) ** 2 + (s2 - s3) ** 2 + (s1 - s3) ** 2) / 6.0
                      + s4 ** 2 + s5 ** 2 + s6 ** 2)


_T23, _T43 = -2.0 / 3.0, 4.0 / 3.0
# C of the 3D law (m_local.F90:255-262); d(beta)/d(sigma)'s constant part
_C3D = ((_T43, _T23, _T23, 0, 0, 0),
        (_T23, _T43, _T23, 0, 0, 0),
        (_T23, _T23, _T43, 0, 0, 0),
        (0, 0, 0, 4.0, 0, 0),
        (0, 0, 0, 0, 4.0, 0),
        (0, 0, 0, 0, 0, 4.0))


def creep_beta3d(stress, visc, expn):
    """Power-law creep strain rate beta(sigma), 3D (m_local.F90:249-263).

    stress: (..., 6) in the order (xx, yy, zz, xy, yz, zx); returns (..., 6).
    """
    cmat = timing.upload(_C3D, dtype=stress.dtype, device=stress.device)
    return (_creep_scale(_kappa3d(stress), visc, expn)[..., None]
            * torch.einsum("ij,...j->...i", cmat, stress))


def creep_betad2d(stress, visc, expn):
    """d(beta)/d(sigma), 2D (m_local.F90:276-288). (..., 3) -> (..., 3, 3).

    Zero where kappa == 0, the reference's early return: kappa is replaced
    by 1 there before any division, so no NaN is formed."""
    s1, s2, s3 = stress.unbind(-1)
    kappa = torch.sqrt(((s1 - s2) / 2.0) ** 2 + s3 ** 2)
    zero = kappa == 0.0
    safe = torch.where(zero, torch.ones_like(kappa), kappa)
    c1 = 1.0 + (expn - 1.0) * ((s1 - s2) / (2.0 * safe)) ** 2
    c2 = 1.0 + (expn - 1.0) * (s3 / safe) ** 2
    c3 = (expn - 1.0) * (s1 * s3 - s2 * s3) / safe ** 2
    rows = torch.stack([
        torch.stack([c1, -c1, c3], dim=-1),
        torch.stack([-c1, c1, -c3], dim=-1),
        torch.stack([c3, -c3, 4.0 * c2], dim=-1),
    ], dim=-2)
    out = _creep_scale(safe, visc, expn)[..., None, None] * rows
    return out.masked_fill(zero[..., None, None], 0.0)


def creep_betad3d(stress, visc, expn):
    """d(beta)/d(sigma), 3D (m_local.F90:292-314). (..., 6) -> (..., 6, 6).

    The reference's form: C + v v^T with v = sqrt(n-1) (the deviator's
    normal components / 3, 2 tau) / kappa. Zero where kappa == 0, as in
    creep_betad2d."""
    s1, s2, s3, s4, s5, s6 = stress.unbind(-1)
    kappa = _kappa3d(stress)
    zero = kappa == 0.0
    safe = torch.where(zero, torch.ones_like(kappa), kappa)
    c = torch.sqrt(timing.upload(expn - 1.0, dtype=stress.dtype,
                                 device=stress.device))
    v = torch.stack([c * (2.0 * s1 - s2 - s3) / (3.0 * safe),
                     c * (2.0 * s2 - s3 - s1) / (3.0 * safe),
                     c * (2.0 * s3 - s1 - s2) / (3.0 * safe),
                     c * 2.0 * s4 / safe, c * 2.0 * s5 / safe,
                     c * 2.0 * s6 / safe], dim=-1)
    cmat = timing.upload(_C3D, dtype=stress.dtype, device=stress.device)
    rows = cmat + v[..., :, None] * v[..., None, :]
    out = _creep_scale(safe, visc, expn)[..., None, None] * rows
    return out.masked_fill(zero[..., None, None], 0.0)
