"""Device-side FEM system, continuum part: assembly, RHS, stress recovery.

Port of `fem_tpu/models/system.py`, the replacement for m_global.F90's
PETSc-centric global layer: the whole system lives in device tensors and
assembly is an index_put/index_add scatter.

A System precomputes, per continuum element type block:
  - gathered element coordinates  (ne, nn, pdim)   (gathered on the host)
  - per-element E, nu             (ne,)   [E=0 for mat -1 — FormLocalK
    m_global.F90:250-253]
  - per-element visc, expn        (ne,)   (material columns 3-4, the power
    law's viscosity and exponent)
  - interleaved dof index arrays  (ne, ndof_e)
and lazily the element stiffness (ne, ndof_e, ndof_e) and D matrices.
It exposes dense_K() / matvec(u) / diag(), rhs(t_init) / rhs_cumulative(t),
bc_step_vals() / bc_total_vals(t) and stress_increment(du).

The viscoelastic terms (fem_tpu `models/system.py:282-371`) are
creep_state_init(), creep_moduli(state), creep_force(state, moduli) and
creep_stress_update(state, du, moduli), and nodal_average_state(state).

The cohesive block, when the deck has one, is kept apart in `self.coh`
(element coordinates, dofs and Xu-Needleman props) and takes no part in the
elastic operator or stress recovery (as in fem_tpu). Its terms are
coh_force(u), coh_stiffness_dense(u), coh_matvec(u, v) and coh_diag(u)
(applyTract_1 / applyStiff_1).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fem_tpu_torch.config import resolve_device
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.ops import cohesive as coh_ops
from fem_tpu_torch.ops import dmat as dmat_ops
from fem_tpu_torch.ops import stiffness as stiff_ops
from fem_tpu_torch.utils import timing

PENALTY = 1.0e30  # PENALTY_PARAM (m_global.F90:15)


class System:
    def __init__(self, problem: Problem, dtype=torch.float64, *, device,
                 plane_stress: bool = False):
        """device: torch device (or its name) every tensor lives on; CUDA
        requested and absent raises.

        plane_stress: treat 2D elements as plane stress instead of the
        reference's plane strain, exactly, via E' = E(1+2nu)/(1+nu)^2,
        nu' = nu/(1+nu) (every plane-strain formula downstream then produces
        the plane-stress law)."""
        self.problem = problem
        self.dtype = dtype
        self.device = resolve_device(device)
        self.plane_stress = bool(plane_stress) and problem.pdim == 2
        p = problem
        self.pdim = p.pdim
        self.cpdim = 3 if p.pdim == 2 else 6
        self.ndof = p.ndof
        self.nnds = p.nnds

        # Material table with a zero row appended so mat == -1 indexes
        # E=0, nu=0 — replicating FormLocalK's explicit zeroing.
        mats = np.vstack([p.mats, np.zeros((1, p.mats.shape[1]))])
        if self.plane_stress:
            E, nu = mats[:, 0].copy(), mats[:, 1].copy()
            mats[:, 0] = E * (1.0 + 2.0 * nu) / (1.0 + nu) ** 2
            mats[:, 1] = nu / (1.0 + nu)

        self.blocks: Dict[str, dict] = {}
        self.coh = None
        for name, b in p.blocks.items():
            if name == "coh":
                conn = self._t(b.conn, torch.int64)
                # props with a zero row appended so nlmat == -1 indexes zeros
                props = np.vstack([np.asarray(p.coh_props).reshape(-1, 6),
                                   np.zeros((1, 6))])[b.nlmat]
                self.coh = dict(ecoords=self._t(p.coords[b.conn]),
                                edofs=stiff_ops.element_dofs(b.et, conn),
                                props=self._t(props))
                continue
            et = b.et
            conn = self._t(b.conn, torch.int64)
            self.blocks[name] = dict(
                et=et,
                conn=conn,
                # gathered on the host: setup is host work, and one numpy
                # gather avoids a device round trip per block
                ecoords=self._t(p.coords[b.conn]),
                edofs=stiff_ops.element_dofs(et, conn),
                E=self._t(mats[b.mat, 0]),
                nu=self._t(mats[b.mat, 1]),
                visc=self._t(mats[b.mat, 2]),
                expn=self._t(mats[b.mat, 3]),
                creeps=bool((mats[b.mat, 2] > 0).any()),
            )

        self.bc_dofs = self._t(p.bc_dofs, torch.int64)
        self.bc_vals = self._t(p.bc_vals)
        self.force_dofs = self._t(p.force_dofs, torch.int64)
        self.force_vec = self._t(p.force_vec)
        self.force_t1 = self._t(p.force_t1)
        self.force_t2 = self._t(p.force_t2)
        self.trac_dofs = self._t(p.trac_dofs, torch.int64)
        self.trac_nodal_vec = self._t(p.trac_nodal_vec)
        # per-node weights: 0.0 on padding rows of mixed-nps traction tables
        self.trac_node_w = self._t(
            p.trac_node_w if p.trac_node_w is not None
            else np.ones(p.trac_dofs.shape[:2]))
        # FormRHS divides traction windows by dt (m_global.F90:414-415) —
        # a reference quirk, replicated for deck compatibility.
        self.trac_t1 = self._t(p.trac_t1 / p.dt)
        self.trac_t2 = self._t(p.trac_t2 / p.dt)

        self.dt = float(p.dt)
        self.t_total = float(p.t)

    def _t(self, a, dtype=None):
        return timing.upload(np.asarray(a), dtype=dtype or self.dtype,
                             device=self.device)

    # ---------------- elastic operator ----------------

    def _continuum(self, need_ke: bool = True):
        """Continuum blocks with lazily built per-element data; need_ke=False
        skips the (ne, ndof_e, ndof_e) element stiffness (stress recovery
        needs only D)."""
        for e in self.blocks.values():
            if need_ke and "ke" not in e:
                e["ke"] = stiff_ops.element_stiffness_isotropic(
                    e["et"], e["ecoords"], e["E"], e["nu"])
            if "D" not in e:
                e["D"] = dmat_ops.dmat(e["E"], e["nu"], self.pdim)
        return list(self.blocks.values())

    def dense_K(self):
        """Assembled elastic stiffness, no BCs (main.F90:157-168). Cached: K
        is constant for the whole run (small-deformation static)."""
        if getattr(self, "_dense_K", None) is None:
            K = torch.zeros((self.ndof, self.ndof), dtype=self.dtype,
                            device=self.device)
            for e in self._continuum():
                edofs = e["edofs"]
                K.index_put_((edofs[:, :, None], edofs[:, None, :]), e["ke"],
                             accumulate=True)
            self._dense_K = K
        return self._dense_K

    def matvec(self, u):
        """Matrix-free K @ u: gather -> batched k_e @ u_e -> scatter-add."""
        out = torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        for e in self._continuum():
            fe = torch.einsum("eab,eb->ea", e["ke"], u[e["edofs"]])
            out.index_add_(0, e["edofs"].reshape(-1), fe.reshape(-1))
        return out

    def diag(self):
        """Diagonal of K (Jacobi preconditioner)."""
        d = torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        for e in self._continuum():
            ke_diag = torch.diagonal(e["ke"], dim1=1, dim2=2)
            d.index_add_(0, e["edofs"].reshape(-1), ke_diag.reshape(-1))
        return d

    # ---------------- loads ----------------

    def rhs(self, t_init, t_end=None):
        """Time-windowed external load vector (FormRHS, m_global.F90:373-436).

        Each step applies the fraction overlap([t_init, t_end], [t1,t2])
        / (t2-t1) of every load (m_global.F90:400-426), t_end = t_init + dt
        by default. BC forcing is NOT included here; solvers apply it per
        bc_mode.
        """
        t_init = timing.upload(t_init, dtype=self.dtype, device=self.device)
        t_end = (t_init + self.dt if t_end is None else timing.upload(
            t_end, dtype=self.dtype, device=self.device))
        F = torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        if self.force_dofs.shape[0]:
            frac = _window_fraction(t_init, t_end, self.force_t1, self.force_t2)
            contrib = self.force_vec * frac[:, None]
            F.index_add_(0, self.force_dofs.reshape(-1), contrib.reshape(-1))
        if self.trac_dofs.shape[0]:
            frac = _window_fraction(t_init, t_end, self.trac_t1, self.trac_t2)
            contrib = self.trac_nodal_vec * frac[:, None]  # (nt, pdim)
            contrib = contrib[:, None, :] * self.trac_node_w[:, :, None]
            F.index_add_(0, self.trac_dofs.reshape(-1), contrib.reshape(-1))
        return F

    def rhs_cumulative(self, t_end):
        """Total external load applied up to t_end: the fraction
        overlap([0, t_end], [t1, t2]) / (t2 - t1) of every load (the per-step
        rhs() fractions sum to exactly this). The total-equilibrium
        formulation's load."""
        return self.rhs(0.0, t_end=t_end)

    def bc_step_vals(self):
        """Per-step prescribed displacement: bcval * dt / t — the linear ramp
        (EnforceBCForce, m_global.F90:451)."""
        return self.bc_vals * (self.dt / self.t_total)

    def bc_total_vals(self, t_end):
        """Total prescribed displacement at t_end under the linear ramp."""
        return self.bc_vals * (float(t_end) / self.t_total)

    # ---------------- cohesive ----------------

    def coh_ke(self, u_total, quirks: bool = False):
        """Cohesive element tangents (ne, 8, 8) at the state u_total."""
        e = self.coh
        return coh_ops.element_stiffness(e["ecoords"], e["props"],
                                         u_total[e["edofs"]], self.dt, quirks)

    def _coh_scatter(self, fe):
        """Scatter-add cohesive element vectors (ne, 8) onto the dofs."""
        out = torch.zeros(self.ndof, dtype=fe.dtype, device=fe.device)
        return out.index_add_(0, self.coh["edofs"].reshape(-1), fe.reshape(-1))

    def coh_force(self, u_total, quirks: bool = False):
        """Global cohesive force F_coh(u_total) scattered to dofs
        (CalcResidual's applyTract_1 + ApplyNodalForce loop,
        m_global.F90:188-206)."""
        e = self.coh
        return self._coh_scatter(coh_ops.element_force(
            e["ecoords"], e["props"], u_total[e["edofs"]], self.dt, quirks))

    def coh_stiffness_dense(self, u_total, quirks: bool = False):
        """Dense cohesive tangent (CalcJacobian's applyStiff_1 scatter,
        m_global.F90:130-150)."""
        edofs = self.coh["edofs"]
        K = torch.zeros((self.ndof, self.ndof), dtype=u_total.dtype,
                        device=u_total.device)
        K.index_put_((edofs[:, :, None], edofs[:, None, :]),
                     self.coh_ke(u_total, quirks), accumulate=True)
        return K

    def coh_apply(self, ke, v):
        """Cohesive tangent times v from element tangents ke (coh_ke)."""
        return self._coh_scatter(torch.einsum(
            "eab,eb->ea", ke, v[self.coh["edofs"]]))

    def coh_matvec(self, u_total, v, quirks: bool = False):
        """Matrix-free cohesive tangent at u_total times v."""
        return self.coh_apply(self.coh_ke(u_total, quirks), v)

    def coh_diag(self, u_total, quirks: bool = False):
        """Diagonal of the cohesive tangent (the Jacobi preconditioner's
        cohesive part)."""
        return self._coh_scatter(torch.diagonal(self.coh_ke(u_total, quirks),
                                                dim1=1, dim2=2))

    # ---------------- viscoelastic creep ----------------

    def creep_state_init(self):
        """Zero per-integration-point stress state for every continuum block
        with a creeping material (visc > 0): {name: (ne, nip, cpdim)}."""
        return {
            name: torch.zeros((e["conn"].shape[0], e["et"].nip, self.cpdim),
                              dtype=self.dtype, device=self.device)
            for name, e in self.blocks.items() if e["creeps"]
        }

    def _creep_D_eff_beta(self, name, sigma_ip):
        """Effective modulus D_eff = (S + dt beta'(sigma))^-1, S = D^-1, and
        the creep rate beta(sigma) at each ip: the reference's intended
        implicit creep correction (ReformElRHS, m_local.F90:127-145).
        Returns ((ne, nip, cpdim, cpdim), (ne, nip, cpdim))."""
        self._continuum(need_ke=False)  # builds D
        e = self.blocks[name]
        if "S" not in e:
            e["S"] = torch.linalg.inv(e["D"])  # constant over the run
        visc, expn = e["visc"][:, None], e["expn"][:, None]
        if self.pdim == 2:
            beta = dmat_ops.creep_beta2d(sigma_ip, visc, expn)
            betad = dmat_ops.creep_betad2d(sigma_ip, visc, expn)
        else:
            beta = dmat_ops.creep_beta3d(sigma_ip, visc, expn)
            betad = dmat_ops.creep_betad3d(sigma_ip, visc, expn)
        betad.mul_(self.dt).add_(e["S"][:, None])
        return torch.linalg.inv(betad), beta

    def creep_moduli(self, creep_state):
        """{name: (D_eff, beta)} at the state: what creep_force and
        creep_stress_update of one step share. Both use the state at the
        start of the step, so one step computes this once and passes it to
        both (fem_tpu recomputes it in each)."""
        return {name: self._creep_D_eff_beta(name, sigma)
                for name, sigma in creep_state.items()}

    def _creep_geometry(self, name):
        """dNx (ne, nip, pdim, nn) and detJ * w (ne, nip) of a creeping
        block, computed at the first call and kept, as S is: creep_force and
        creep_stress_update read them every step (0.79 GB of dNx in float64
        at 80^3)."""
        e = self.blocks[name]
        if "dNx" not in e:
            dNx, detj = stiff_ops.grad_and_detj(e["et"], e["ecoords"])
            e["dNx"] = dNx
            e["wdetj"] = detj * self._t(e["et"].weights)[None, :]
        return e["dNx"], e["wdetj"]

    def creep_force(self, creep_state, moduli):
        """RHS correction f = sum_ip B^T D_eff (dt beta) w detJ scattered to
        global dofs (the live version of the reference's dead ReformElRHS),
        from the step's creep_moduli(creep_state). B^T g is contracted as
        dNx^T T, T the symmetric tensor of the Voigt vector g, so B is never
        formed."""
        F = torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        for name, (D_eff, beta) in moduli.items():
            e = self.blocks[name]
            dNx, wdetj = self._creep_geometry(name)
            g = torch.einsum("eicd,eid->eic", D_eff, self.dt * beta)
            T = _voigt_tensor(g * wdetj[..., None], self.pdim)
            fe = torch.einsum("eipn,eipd->end", dNx, T)
            F.index_add_(0, e["edofs"].reshape(-1), fe.reshape(-1))
        return F

    def creep_stress_update(self, creep_state, du, moduli):
        """Backward-Euler stress update per ip, from the step's
        creep_moduli(creep_state): sigma += D_eff (B du - dt beta(sigma))."""
        new_state = {}
        for name, sigma_ip in creep_state.items():
            e = self.blocks[name]
            D_eff, beta = moduli[name]
            dNx, _ = self._creep_geometry(name)
            ue = du[e["edofs"]].reshape(dNx.shape[0], -1, self.pdim)
            eps = _voigt_strain(torch.einsum("eipn,end->eipd", dNx, ue),
                                self.pdim)
            new_state[name] = sigma_ip + torch.einsum(
                "eicd,eid->eic", D_eff, eps - self.dt * beta)
        return new_state

    def nodal_average_state(self, state_by_block):
        """Nodal average of per-ip stress states {name: (ne, nip, cpdim)}
        (the viscoelastic run's output field; extrapolation and
        count-average as in stress_increment)."""
        sums = torch.zeros((self.nnds, self.cpdim), dtype=self.dtype,
                           device=self.device)
        counts = torch.zeros(self.nnds, dtype=self.dtype, device=self.device)
        for name, sigma_ip in state_by_block.items():
            e = self.blocks[name]
            sig_nodes = stiff_ops.nodal_stress(e["et"], sigma_ip)
            conn_flat = e["conn"].reshape(-1)
            sums.index_add_(0, conn_flat, sig_nodes.reshape(-1, self.cpdim))
            counts.index_add_(0, conn_flat, torch.ones_like(conn_flat,
                                                            dtype=self.dtype))
        return sums / torch.clamp(counts, min=1.0)[:, None]

    # ---------------- stress ----------------

    def stress_increment(self, du):
        """Nodal-averaged stress from the step increment du.

        Mirrors RecoverStress + RecoverNodalStress + the count/average block
        (m_global.F90:466-515, main.F90:252-291): per-element ip stress from
        the *increment*, extrapolated to nodes, summed per node, divided by
        the number of contributing elements. Cohesive elements are excluded
        (the reference's coh branch is undefined behaviour, see fem_tpu).
        Returns (nnds, cpdim).
        """
        sums = torch.zeros((self.nnds, self.cpdim), dtype=self.dtype,
                           device=self.device)
        counts = torch.zeros(self.nnds, dtype=self.dtype, device=self.device)
        for e in self._continuum(need_ke=False):
            et = e["et"]
            sig_ip = stiff_ops.element_stress(et, e["ecoords"], du[e["edofs"]],
                                              e["D"])
            sig_nodes = stiff_ops.nodal_stress(et, sig_ip)
            conn_flat = e["conn"].reshape(-1)
            sums.index_add_(0, conn_flat, sig_nodes.reshape(-1, self.cpdim))
            counts.index_add_(0, conn_flat, torch.ones_like(conn_flat,
                                                            dtype=self.dtype))
        return sums / torch.clamp(counts, min=1.0)[:, None]


def _window_fraction(t_init, t_end, t1, t2):
    """overlap([t_init,t_end],[t1,t2]) / (t2-t1), zero outside the window
    (m_global.F90:400-426). Zero-length windows are guarded to 0."""
    applied = torch.minimum(t2, t_end) - torch.maximum(t1, t_init)
    width = t2 - t1
    active = (t_end >= t1) & (t_init <= t2) & (width > 0)
    return torch.where(active, applied / torch.where(width > 0, width,
                                                     torch.ones_like(width)),
                       torch.zeros_like(width))


def _voigt_tensor(g, pdim):
    """Symmetric (pdim, pdim) tensor of Voigt vectors g (..., cpdim) in
    BMat's order (xx, yy, xy) / (xx, yy, zz, xy, yz, zx): B^T g at a node
    is dNx^T of it."""
    if pdim == 2:
        xx, yy, xy = g.unbind(-1)
        rows = [(xx, xy), (xy, yy)]
    else:
        xx, yy, zz, xy, yz, zx = g.unbind(-1)
        rows = [(xx, xy, zx), (xy, yy, yz), (zx, yz, zz)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _voigt_strain(G, pdim):
    """Engineering strain B u in Voigt order from the displacement gradient
    G[p, d] = d u_d / d x_p (..., pdim, pdim)."""
    if pdim == 2:
        return torch.stack([G[..., 0, 0], G[..., 1, 1],
                            G[..., 1, 0] + G[..., 0, 1]], dim=-1)
    return torch.stack([G[..., 0, 0], G[..., 1, 1], G[..., 2, 2],
                        G[..., 1, 0] + G[..., 0, 1],
                        G[..., 2, 1] + G[..., 1, 2],
                        G[..., 2, 0] + G[..., 0, 2]], dim=-1)
