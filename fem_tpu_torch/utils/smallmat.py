"""Small dense matrix helpers (batched, closed form), in torch.

Port of `fem_tpu.utils.smallmat`: the reference's LAPACK usage
(m_utils.F90:45-66: MatInv via dgetrf/dgetri, MatDet) and its 3D area helpers
(m_utils.F90:25-42) as closed-form 2x2/3x3 determinants and inverses, batched
over leading axes (no pivoting, no data-dependent control flow).
"""

from __future__ import annotations

import torch


def det2(a):
    """Determinant of a (...,2,2) tensor."""
    return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]


def det3(a):
    """Determinant of a (...,3,3) tensor (cofactor expansion, m_utils.F90:64)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def det(a):
    """Determinant of a (...,d,d) tensor for d in {2,3}."""
    d = a.shape[-1]
    if d == 2:
        return det2(a)
    if d == 3:
        return det3(a)
    raise ValueError(f"det: unsupported size {d}")


def inv2(a):
    """Inverse of a (...,2,2) tensor, closed form."""
    d = det2(a)[..., None, None]
    row0 = torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1)
    row1 = torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1)
    return torch.stack([row0, row1], dim=-2) / d


def inv3(a):
    """Inverse of a (...,3,3) tensor via the adjugate."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det3(a)[..., None, None]


def inv(a):
    """Inverse of a (...,d,d) tensor for d in {2,3}."""
    d = a.shape[-1]
    if d == 2:
        return inv2(a)
    if d == 3:
        return inv3(a)
    raise ValueError(f"inv: unsupported size {d}")


def tri_area3d(p1, p2, p3):
    """Area of a triangle in 3D space (m_utils.F90:25-33): half the norm of
    the cross product of two edges. Arguments are (...,3) point tensors."""
    cross = torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
    return 0.5 * torch.sqrt(torch.sum(cross * cross, dim=-1))


def quad_area3d(p1, p2, p3, p4):
    """Area of a (planar) quad in 3D as two triangles (m_utils.F90:36-42)."""
    return tri_area3d(p1, p2, p3) + tri_area3d(p1, p3, p4)


def magnitude(v):
    """Vector 2-norm over the last axis (m_utils.F90:69-81)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))
