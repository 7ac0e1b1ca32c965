"""The plain reference of the cohesive decks: quad blocks glued by 4-node
cohesive elements, loaded in steps, each step brought to true equilibrium by
a full Newton on the assembled sparse tangent.

The law is Xu & Needleman's (J. Mech. Phys. Solids 42 (1994) 1397), in the
parameters of the upstream's `m_seplaw.F90:15-94`: props = (sigma_max,
delta_n, delta_t, q, r, zeta). With x = D_n / delta_n, E_t =
exp(-D_t^2 / delta_t^2), phi_n = e sigma_max delta_n, A = (1 - q) / (r - 1)
and B = (r - q) / (r - 1), the potential is

    phi = phi_n + phi_n exp(-x) [(1 - r + x) A - (q + B x) E_t],

and the tractions and their tangent are its derivatives, written out here:

    T_n = phi_n / delta_n exp(-x) [A (r - x) + E_t (B x - r A)]
    T_t = 2 phi_n D_t / delta_t^2 (q + B x) exp(-x) E_t
    dT_n/dD_n = phi_n / delta_n^2 exp(-x) [E_t (B (1 - x) + r A)
                                            - A (r + 1 - x)]
    dT_n/dD_t = dT_t/dD_n = 2 phi_n D_t / (delta_n delta_t^2)
                             (r A - B x) exp(-x) E_t
    dT_t/dD_t = 2 phi_n / delta_t^2 (q + B x) exp(-x) E_t
                (1 - 2 D_t^2 / delta_t^2).

The element: nodes (bottom-left, bottom-right, top-right, top-left), the top
pair over the bottom pair. Along the midline, xi in [-1, 1], the opening is
the top face's displacement less the bottom's, linear in xi; its normal and
tangential parts D_n, D_t are taken in the frame of the undeformed midline
(tangent from the left pair's midpoint to the right pair's, normal its left
turn), at the two Gauss points xi = -/+ 1/sqrt(3), weight 1 each, times
half the midline's length. The element's internal force is the integral of
(dD/du)^T T; its tangent, of (dD/du)^T dT/dD (dD/du).

Departures from the upstream: the viscous term (zeta) is not modelled, and
a deck with zeta != 0 is refused; the upstream's two defects in its element
assembly (only the last integration point's force, `m_global.F90:669`; the
normal column's missing scale, `m_global.F90:829-831`) are not reproduced,
as the Abaqus UEL of its own cross-validation does not have them; held
displacements are eliminated, not penalized.

A load step k ends at t_k = k dt: the held dofs take their value times
t_k / t, the point loads their share up to t_k, and Newton solves
K_el u + f_coh(u) = F(t_k) from the last step's u plus its increment. Each
Newton iteration assembles K_el + K_coh(u) as one CSR matrix and solves it
directly (`linalg.block_tridiagonal_solve`, the dofs in the order of x), a
backtracking line search takes the step, and the step ends where ||R|| <=
1e-12 ||R_0|| on the free dofs, where no step lowers ||R||, or where, once
||R|| <= 1e-6 ||R_0||, an iteration no longer halves it: there rounding,
not the law, sets the residual (in float64 near 1e-13 ||R_0|| on the strip).
No Krylov solver, no hierarchy, no forcing term.
"""

from __future__ import annotations

import numpy as np
import torch

from fembench.reference import fe, linalg, load_steps

GAUSS = np.array([-1.0, 1.0]) / np.sqrt(3.0)
# per node: the sign of its displacement in the opening (top minus bottom),
# and which end of the midline it lies at (0 left, 1 right)
SIGN = np.array([-1.0, -1.0, 1.0, 1.0])
END = np.array([0, 1, 1, 0])


def law(props, dn_, dt_):
    """(T_n, T_t, k_nn, k_nt, k_tt) at the openings D_n, D_t (tensors of one
    shape); props = (sigma_max, delta_n, delta_t, q, r, zeta)."""
    smax, dn, dtt, q, r, zeta = (float(p) for p in props)
    if zeta != 0.0:
        raise ValueError("the reference has no viscous term (zeta != 0)")
    phi = np.e * smax * dn
    a = (1.0 - q) / (r - 1.0)
    b = (r - q) / (r - 1.0)
    x = dn_ / dn
    ex = torch.exp(-x)
    et = torch.exp(-(dt_ / dtt) ** 2)
    t_n = phi / dn * ex * (a * (r - x) + et * (b * x - r * a))
    t_t = 2.0 * phi * dt_ / dtt ** 2 * (q + b * x) * ex * et
    k_nn = phi / dn ** 2 * ex * (et * (b * (1.0 - x) + r * a)
                                 - a * (r + 1.0 - x))
    k_nt = 2.0 * phi * dt_ / (dn * dtt ** 2) * (r * a - b * x) * ex * et
    k_tt = (2.0 * phi / dtt ** 2 * (q + b * x) * ex * et
            * (1.0 - 2.0 * dt_ ** 2 / dtt ** 2))
    return t_n, t_t, k_nn, k_nt, k_tt


def potential(props, dn_, dt_):
    """phi(D_n, D_t) of the law (the tests' finite differences)."""
    smax, dn, dtt, q, r, _ = (float(p) for p in props)
    phi = np.e * smax * dn
    a = (1.0 - q) / (r - 1.0)
    b = (r - q) / (r - 1.0)
    x = dn_ / dn
    return phi + phi * torch.exp(-x) * ((1.0 - r + x) * a - (q + b * x)
                                        * torch.exp(-(dt_ / dtt) ** 2))


class Interface:
    """The cohesive elements of a deck: their dofs and, per element and
    Gauss point, the map from the element's 8 dofs to (D_n, D_t) and the
    weight times half the midline's length."""

    def __init__(self, coords, conn, props, *, dtype, device):
        coords = np.asarray(coords, float)
        conn = np.asarray(conn, np.int64)
        x = coords[conn]  # (ne, 4, 2)
        # from the left pair's midpoint to the right pair's
        axis = 0.5 * (x[:, 1] + x[:, 2]) - 0.5 * (x[:, 0] + x[:, 3])
        length = np.linalg.norm(axis, axis=1)
        tan = axis / length[:, None]
        nrm = np.stack([-tan[:, 1], tan[:, 0]], axis=1)
        ends = np.stack([(1.0 - GAUSS) / 2.0, (1.0 + GAUSS) / 2.0], axis=1)
        shape = ends[:, END] * SIGN  # (nip, 4): d(opening) / d(u_node)
        # G[e, i, c, 2a + d]: d(D_c) / d(u_{a,d}), c = 0 normal, 1 tangent
        frame = np.stack([nrm, tan], axis=1)  # (ne, 2, 2)
        G = np.einsum("ia,ecd->eicad", shape, frame).reshape(
            conn.shape[0], len(GAUSS), 2, 8)
        self.dtype, self.device = dtype, torch.device(device)
        self.G = torch.as_tensor(G, dtype=dtype, device=self.device)
        self.wdet = torch.as_tensor(
            np.repeat(0.5 * length[:, None], len(GAUSS), axis=1),
            dtype=dtype, device=self.device)
        self.dofs = torch.as_tensor(
            (conn[:, :, None] * 2 + np.arange(2)).reshape(-1, 8),
            device=self.device)
        self.props = props

    def openings(self, u):
        """(D_n, D_t) at each element's Gauss points, (ne, nip) each."""
        d = torch.einsum("eicj,ej->eic", self.G, u[self.dofs])
        return d[..., 0], d[..., 1]

    def force_and_tangent(self, u, n):
        """The internal force (n,) and the element tangents (ne, 8, 8)."""
        d_n, d_t = self.openings(u)
        t_n, t_t, k_nn, k_nt, k_tt = law(self.props, d_n, d_t)
        trac = torch.stack([t_n, t_t], dim=-1)
        fe_ = torch.einsum("eicj,eic,ei->ej", self.G, trac, self.wdet)
        f = torch.zeros(n, dtype=u.dtype, device=u.device)
        f.index_add_(0, self.dofs.reshape(-1), fe_.reshape(-1))
        D = torch.stack([torch.stack([k_nn, k_nt], -1),
                         torch.stack([k_nt, k_tt], -1)], -2)
        ke = torch.einsum("eicj,eicd,eidk,ei->ejk", self.G, D, self.G,
                          self.wdet)
        return f, ke

    def force(self, u, n):
        return self.force_and_tangent(u, n)[0]


def _triplets(K):
    crow = K.crow_indices()
    rows = torch.repeat_interleave(
        torch.arange(K.shape[0], device=crow.device), crow[1:] - crow[:-1])
    return rows, K.col_indices(), K.values()


class Deck:
    """The assembled parts of one deck: the quads' mesh and K_el, the
    interface, the held dofs' mask and the load's arrays."""

    def __init__(self, deck, dtype, device):
        self.deck = deck
        self.mesh = fe.Mesh(deck["coords"], deck["conn"], deck["E"],
                            deck["nu"], dtype=dtype, device=device)
        self.n = self.mesh.ndof
        self.K = self.mesh.stiffness()
        self.coh = Interface(deck["coords"], deck["coh_conn"],
                             deck["coh_props"], dtype=dtype, device=device)
        self.held = torch.as_tensor(np.asarray(deck["bc_dofs"], np.int64),
                                    device=self.mesh.device)
        self.free = torch.ones(self.n, dtype=dtype, device=self.mesh.device)
        self.free[self.held] = 0.0
        self.dtype = dtype

    def load(self, t_end):
        d = self.deck
        return torch.as_tensor(fe.load_vector(
            self.n, d["force_dofs"], d["force_vec"], d["force_t1"],
            d["force_t2"], 0.0, t_end), dtype=self.dtype,
            device=self.mesh.device)

    def residual(self, u, F):
        """K_el u + f_coh(u) - F on the free dofs, 0 on the held ones."""
        return self.free * (self.K @ u + self.coh.force(u, self.n) - F)

    def tangent(self, u):
        """K_el + K_coh(u) as one CSR matrix."""
        _, ke = self.coh.force_and_tangent(u, self.n)
        r, c, v = _triplets(self.K)
        ed = self.coh.dofs
        rows = torch.cat([r, ed[:, :, None].expand(-1, 8, 8).reshape(-1)])
        cols = torch.cat([c, ed[:, None, :].expand(-1, 8, 8).reshape(-1)])
        return fe.csr_from_triplets(rows, cols, torch.cat([v, ke.reshape(-1)]),
                                    self.n)


def run(deck, dtype=torch.float64, device="cpu", rtol=1e-12, maxit=50,
        halvings=30):
    """{'u': (ndof,), 'stress': (nnds, 3), 'openings': (nc, nip, 2),
    'newton': [iterations per step]} as numpy. The deck: coords, conn (the
    quads), E, nu, coh_conn, coh_props (6,), bc_dofs, bc_vals, force_dofs,
    force_vec, force_t1, force_t2, t, dt."""
    old_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(deck, dtype, torch.device(device), rtol, maxit, halvings)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old_tf32


def _run(deck, dtype, device, rtol, maxit, halvings):
    d = Deck(deck, dtype, device)
    order = linalg.band_order(np.asarray(deck["coords"], float), 2)
    t, dt = float(deck["t"]), float(deck["dt"])
    bc_vals = torch.as_tensor(np.asarray(deck["bc_vals"], float), dtype=dtype,
                              device=device)
    u = torch.zeros(d.n, dtype=dtype, device=device)
    du = torch.zeros_like(u)
    newton = []
    for k in range(1, load_steps(t, dt) + 1):
        t_end = dt * k
        F = d.load(t_end)
        x = u + du
        x[d.held] = bc_vals * (t_end / t)
        R = d.residual(x, F)
        r0 = rnorm = float(torch.linalg.norm(R))
        its = 0
        while rnorm > rtol * r0 and its < maxit:
            A = linalg.Constrained(d.tangent(x), deck["bc_dofs"], d.n, dtype,
                                   device)
            delta = linalg.block_tridiagonal_solve(A, -R, order, refine=0)
            lam, best = 1.0, None
            for _ in range(halvings):
                trial = x + lam * delta
                Rt = d.residual(trial, F)
                rt = float(torch.linalg.norm(Rt))
                if np.isfinite(rt) and rt <= (1.0 - 1e-4 * lam) * rnorm:
                    best = (trial, Rt, rt)
                    break
                lam *= 0.5
            if best is None:
                break  # no step lowers ||R||: the dtype's floor
            x, R, last, rnorm = best[0], best[1], rnorm, best[2]
            its += 1
            if rnorm <= rtol ** 0.5 * r0 and rnorm > 0.5 * last:
                break  # past quadratic convergence: the dtype's floor
        newton.append(its)
        du = x - u
        u = x
    op_n, op_t = d.coh.openings(u)
    return dict(u=u.cpu().numpy(), stress=d.mesh.stress(u).cpu().numpy(),
                openings=torch.stack([op_n, op_t], -1).cpu().numpy(),
                newton=newton)


def residual(deck, u, device="cpu"):
    """The true equilibrium residual of the answer u at the deck's end, in
    float64: ||K_el u + f_coh(u) - F||_free / ||K_el u||_free."""
    d = Deck(deck, torch.float64, device)
    u = torch.as_tensor(np.asarray(u, float), dtype=torch.float64,
                        device=device)
    R = d.residual(u, d.load(float(deck["t"])))
    return float(torch.linalg.norm(R)
                 / torch.linalg.norm(d.free * (d.K @ u)))


def openings(deck, u, device="cpu"):
    """(D_n, D_t) of the answer u at each cohesive element's Gauss points,
    (nc, nip, 2), in float64."""
    coh = Interface(deck["coords"], deck["coh_conn"], deck["coh_props"],
                    dtype=torch.float64, device=device)
    d_n, d_t = coh.openings(torch.as_tensor(np.asarray(u, float),
                                            dtype=torch.float64,
                                            device=device))
    return torch.stack([d_n, d_t], -1).cpu().numpy()
