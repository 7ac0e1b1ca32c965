"""Constitutive models: isotropic linear elasticity, in torch.

Port of `fem_tpu.ops.dmat`'s DMat2d/DMat3d (m_local.F90:204-228). The
power-law creep functions (m_local.F90:231-314) are not ported yet
(ROADMAP A.8). All functions are batched over leading axes.
"""

from __future__ import annotations

import torch


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
