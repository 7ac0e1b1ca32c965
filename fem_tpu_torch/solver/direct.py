"""Dense direct solve — the small-problem stand-in for MUMPS.

Port of `fem_tpu.solver.direct`. The reference always factorizes with a
distributed sparse direct LU (MUMPS via PETSc PCLU, main.F90:354-390). For
the small shipped examples a dense LU with partial pivoting
(torch.linalg.lu_factor) on the tensor's own device, in its own dtype
(float64 on the H100 too), plays that role; large problems take the
matrix-free Krylov path (solver/cg.py). `robust_solve` is the dense Newton
step's solve with MUMPS-style null-pivot handling.
"""

from __future__ import annotations

import numpy as np
import torch


def factorize(K):
    """LU-factorize once; reuse across time steps (the reference sets up the
    KSP once, main.F90:199-214). Returns (LU, pivots), pivots 1-based as
    LAPACK gives them."""
    return torch.linalg.lu_factor(K)


def solve_factorized(fac, F):
    lu, piv = fac
    return torch.linalg.lu_solve(lu, piv, F[:, None])[:, 0]


def det_report(fac, null_rtol: float = 1e-12, ref_scale=None):
    """MUMPS-style determinant/pivot telemetry from an LU factorization.

    The reference prints, after every MUMPS factorization, the determinant of
    the (penalized) stiffness as mantissa * 2^exponent together with its
    null-pivot settings (print code main.F90:379-390). Returns (mantissa,
    exponent, n_null) computed host-side from the U diagonal: the mantissa
    carries the sign (permutation parity x product of diagonal signs) and
    lies in +-[0.5, 1); n_null counts pivots below null_rtol x the PHYSICAL
    stiffness scale (`ref_scale` = max|K| before penalization; falls back to
    median|U_ii|). A zero pivot returns (0.0, 0, n_null).
    """
    lu, piv = fac[0].cpu().numpy(), fac[1].cpu().numpy()
    d = np.diagonal(lu)
    ad = np.abs(d)
    if ref_scale is None:
        ref_scale = float(np.median(ad)) if ad.size else 0.0
    n_null = int(np.sum(ad <= null_rtol * float(ref_scale)))
    swaps = np.sum(piv != np.arange(1, piv.shape[0] + 1))
    sign = -1.0 if swaps % 2 else 1.0
    sign *= float(np.prod(np.where(d < 0.0, -1.0, 1.0)))
    if np.any(d == 0.0):
        return 0.0, 0, n_null
    log2_total = float(np.sum(np.log2(ad)))
    # floor+1, not ceil: an exact det = 2^k must give mantissa 0.5, not 1.0
    exp = int(np.floor(log2_total)) + 1
    mant = sign * 2.0 ** (log2_total - exp)  # |mant| in [0.5, 1)
    return mant, exp, n_null


def apply_penalty_bcs(K, F, bc_dofs, bc_step_vals, penalty):
    """Reference penalty BC application (ApplyKBC m_global.F90:264-299 +
    EnforceBCForce m_global.F90:439-455): diag <- penalty (insert),
    F[bc] <- penalty * u_bc_step (insert). Returns new tensors."""
    K = K.clone()
    F = F.clone()
    K[bc_dofs, bc_dofs] = penalty
    F[bc_dofs] = penalty * bc_step_vals
    return K, F


def eliminate_bcs(K, F, bc_dofs, bc_step_vals):
    """Exact-constraint variant: zero the bc rows/cols, unit diagonal,
    F_free -= K[:, bc] @ u_bc, F[bc] = u_bc. Identical solution to the
    penalty method in the penalty->inf limit, but well-conditioned."""
    n = K.shape[0]
    ubc = torch.zeros(n, dtype=K.dtype, device=K.device)
    ubc[bc_dofs] = bc_step_vals
    F = F - K @ ubc
    mask = torch.zeros(n, dtype=torch.bool, device=K.device)
    mask[bc_dofs] = True
    K = torch.where(mask[:, None] | mask[None, :], torch.zeros_like(K), K)
    K[bc_dofs, bc_dofs] = 1.0
    F = torch.where(mask, ubc, F)
    return K, F


def robust_solve(J, rhs, ref=None):
    """Dense solve with null-pivot regularization, on J's own device.

    The reference relies on MUMPS null-pivot detection (icntl(24)=1 with
    cntl(3)=1e-6, main.F90:365-371) so that fully separated cohesive
    interfaces, whose dofs keep ~zero stiffness, still factorize. Here dofs
    whose row of J is numerically null (max |J_ij| <= 1e-12 ref) are pinned:
    unit diagonal, zero rhs, no correction. If the LU still meets an exactly
    zero pivot (`info` > 0) or gives a non-finite x, the minimum-norm
    solution comes from the SVD pseudo-inverse instead.

    `ref` is the PHYSICAL stiffness scale, max |K_el|. Callers with penalty
    BCs must pass it: the 1e30 penalty diagonal would otherwise set the scale
    and flag every physical row as null (MUMPS equilibrates before it detects
    null pivots, so its scale never sees the penalty).
    """
    row_scale = J.abs().amax(dim=1)
    if ref is None:
        ref = row_scale.max()
    null = row_scale <= 1e-12 * ref
    if bool(null.any()):
        J = torch.where(null[:, None] | null[None, :], torch.zeros_like(J), J)
        J = J + torch.diag(null.to(J.dtype))
        rhs = torch.where(null, torch.zeros_like(rhs), rhs)
    lu, piv, info = torch.linalg.lu_factor_ex(J)
    if int(info) == 0:
        x = torch.linalg.lu_solve(lu, piv, rhs[:, None])[:, 0]
        if bool(torch.isfinite(x).all()):
            return x
    return torch.linalg.pinv(J) @ rhs
