"""The benchmark's plain reference: the same decks solved by straightforward
PyTorch and NumPy code that shares nothing with the program under test.

`run(deck, dtype, device)` takes a deck as plain arrays (one block of quads
or hexes, one material, held dofs, point loads, the time window) and returns
the summed displacement and the nodal stress after its last load step, as
the program's time loop defines them: each step solves K du = F(step) with
the held dofs at their share of the ramp; u sums the du; elastic stress sums
each step's nodal stress of du; under creep (the deck's `creep` flag) the
load gains the creep term and the output stress is the nodal average of the
Gauss-point stress history.

Given `judge_du`, another solver's increment of the last load step, it also
returns that increment's true relative residual in the last step's system,
||b - K du|| / ||b||, with its own K and its own right-hand side (which,
under creep, carries its own stress history).
"""

from __future__ import annotations

import numpy as np
import torch

from fembench.reference import creep, fe, linalg

# a dof band up to this wide is solved directly, a wider one by CG
DIRECT_BAND = 1024


def load_steps(t, dt):
    """Step count: k = 1, 2, ... while dt (k - 1) < t."""
    k = 1
    while dt * (k - 1) < t:
        k += 1
    return k - 1


def band_width(coords, conn, pdim):
    """Width in dofs of K's band in `linalg.band_order`."""
    order = linalg.band_order(coords, pdim)[::pdim] // pdim
    pos = np.empty_like(order)
    pos[order] = np.arange(order.shape[0])
    p = pos[conn]
    return int((p.max(axis=1) - p.min(axis=1)).max() + 1) * pdim


def run(deck, dtype=torch.float64, device="cpu", rtol=1e-12, maxiter=20000,
        judge_du=None):
    """{'u': (ndof,), 'du': (ndof,), 'stress': (nnds, cp), 'iters': [...]}
    as numpy, and 'residual' where `judge_du` is given."""
    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(deck, dtype, torch.device(device), rtol, maxiter,
                    judge_du)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old_tf32


def _run(deck, dtype, device, rtol, maxiter, judge_du):
    coords, conn = np.asarray(deck["coords"]), np.asarray(deck["conn"])
    mesh = fe.Mesh(coords, conn, deck["E"], deck["nu"], dtype=dtype,
                   device=device)
    n = mesh.ndof
    A = linalg.Constrained(mesh.stiffness(), deck["bc_dofs"], n, dtype,
                           device)
    t, dt = float(deck["t"]), float(deck["dt"])
    ubc = torch.zeros(n, dtype=dtype, device=device)
    ubc[torch.as_tensor(np.asarray(deck["bc_dofs"], np.int64),
                        device=device)] = torch.as_tensor(
        np.asarray(deck["bc_vals"], float) * (dt / t), dtype=dtype,
        device=device)
    direct = band_width(coords, conn, mesh.pdim) <= DIRECT_BAND
    order = linalg.band_order(coords, mesh.pdim) if direct else None
    creeps = bool(deck.get("creep"))
    if creeps and mesh.pdim != 3:
        raise ValueError("the reference's creep law is the 3D one")
    sigma = torch.zeros((mesh.ne, mesh.nip, mesh.cp), dtype=dtype,
                        device=device)
    u = torch.zeros(n, dtype=dtype, device=device)
    du = torch.zeros(n, dtype=dtype, device=device)
    stress = torch.zeros((mesh.nnds, mesh.cp), dtype=dtype, device=device)
    iters = []
    residual = None
    nsteps = load_steps(t, dt)
    for k in range(1, nsteps + 1):
        t0 = dt * (k - 1)
        F = torch.as_tensor(fe.load_vector(
            n, deck["force_dofs"], deck["force_vec"], deck["force_t1"],
            deck["force_t2"], t0, t0 + dt), dtype=dtype, device=device)
        if creeps:
            D_eff, dt_beta, extra = creep.step_terms(
                mesh, sigma, float(deck["visc"]), float(deck["expn"]), dt)
            F = F + extra
        b = A.rhs(F, ubc)
        if k == nsteps and judge_du is not None:
            other = torch.as_tensor(np.asarray(judge_du, float), dtype=dtype,
                                    device=device)
            residual = (float(torch.linalg.norm(b - A.apply(other))
                              / torch.linalg.norm(b))
                        if other.shape == b.shape else float("inf"))
            del other
        if direct:
            du = linalg.block_tridiagonal_solve(A, b, order)
            iters.append(0)
        else:
            x0 = torch.where(A.free > 0, du, ubc)
            du, it = linalg.pcg(A, b, x0, rtol, maxiter)
            iters.append(it)
        u = u + du
        if creeps:
            sigma = creep.update(mesh, sigma, du, D_eff, dt_beta)
            del D_eff, dt_beta
        else:
            stress = stress + mesh.stress(du)
    if creeps:
        stress = mesh.nodal_average(sigma)
    out = dict(u=u.cpu().numpy(), du=du.cpu().numpy(),
               stress=stress.cpu().numpy(), iters=iters)
    if residual is not None:
        out["residual"] = residual
    return out
