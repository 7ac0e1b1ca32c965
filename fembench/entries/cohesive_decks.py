"""Cohesive decks: one cohesive strip from the configuration's generator
(`cohesive_strip`, below), and per deck a fresh
`fem_tpu_torch.solver.stepper.run(problem, Config(...))` with the top
edge's pull drawn per deck (`dataclasses.replace` of the held values,
outside the clock), as a user's script ramps a cohesive interface toward its
traction peak.

Traffic keys: `t`, `dt` (the load steps), `formulation` (the program's
cohesive residual), `open_disp` ([lo, hi]: the top edge's total pull, drawn
per deck from U[lo, hi]), `check_decks`, `profile_decks`.

`cohesive_strip` is a frozen copy of `fem_tpu_torch.io.meshgen.
cohesive_interface_problem`, returning plain arrays in place of a `Problem`;
a test holds it against the program's at a small size. A deck has failed
where any of its steps' Newton did not converge, or its answer is not
finite. Its comparison is with `fembench/reference/cohesive.py`, whose
float32 run is the control.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fembench.harness import compare, program
from fembench.harness.entry import DeckEntry
from fembench.harness.loop import span
from fembench.reference import cohesive


def cohesive_strip(nx, ny_half, lx=1.0, ly_half=1.0, E=3640.0, nu=0.3, t=1.0,
                   dt=0.1, open_disp=0.02,
                   coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0)):
    """Two nx x ny_half quad blocks, each lx x ly_half, the top one on the
    bottom one, glued by nx cohesive elements on duplicated interface
    nodes (bottom-left, bottom-right, top-right, top-left); the bottom edge
    clamped, the top edge held in x and pulled up by open_disp. Plain arrays
    with the fields of the program's Problem; `blocks` maps 'qua' and 'coh'
    to their conn, mat, nlmat and eids."""
    nnx = nx + 1
    n_block = nnx * (ny_half + 1)
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly_half, ny_half + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    bot = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    top = bot.copy()
    top[:, 1] += ly_half
    coords = np.vstack([bot, top])

    def block_conn(offset):
        i, j = np.meshgrid(np.arange(ny_half), np.arange(nx), indexing="ij")
        n1 = (j + i * nnx).reshape(-1) + offset
        return np.stack([n1, n1 + 1, n1 + 1 + nnx, n1 + nnx], axis=1)

    qconn = np.vstack([block_conn(0), block_conn(n_block)]).astype(np.int32)
    nq = qconn.shape[0]
    b_row = np.arange(nnx) + ny_half * nnx
    t_row = np.arange(nnx) + n_block
    cconn = np.stack([b_row[:-1], b_row[1:], t_row[1:], t_row[:-1]],
                     axis=1).astype(np.int32)
    nc = cconn.shape[0]
    bottom = np.nonzero(coords[:, 1] == 0.0)[0]
    top_nodes = np.arange(n_block + ny_half * nnx, 2 * n_block)
    bc_dofs = np.concatenate([(bottom[:, None] * 2 + np.arange(2)).reshape(-1),
                              top_nodes * 2 + 1, top_nodes * 2]).astype(
                                  np.int32)
    bc_vals = np.concatenate([np.zeros(bottom.shape[0] * 2),
                              np.full(top_nodes.shape[0], open_disp),
                              np.zeros(top_nodes.shape[0])])
    return dict(
        stype="implicit", pdim=2, t=t, dt=dt, coords=coords,
        blocks={"qua": dict(conn=qconn, mat=np.zeros(nq, np.int32),
                            nlmat=np.full(nq, -1, np.int32),
                            eids=np.arange(nq, dtype=np.int32)),
                "coh": dict(conn=cconn, mat=np.full(nc, -1, np.int32),
                            nlmat=np.zeros(nc, np.int32),
                            eids=np.arange(nq, nq + nc, dtype=np.int32))},
        mats=np.array([[E, nu, 0.0, 1.0, 0.0]]),
        coh_laws=np.array([1], dtype=np.int32),
        coh_props=np.array([coh_props], dtype=float),
        bc_dofs=bc_dofs, bc_vals=bc_vals,
        force_dofs=np.zeros((0, 2), np.int32), force_vec=np.zeros((0, 2)),
        force_t1=np.zeros(0), force_t2=np.zeros(0),
        trac_dofs=np.zeros((0, 2, 2), np.int32),
        trac_nodal_vec=np.zeros((0, 2)), trac_t1=np.zeros(0),
        trac_t2=np.zeros(0))


def reference_deck(arrays: dict, bc_vals) -> dict:
    """The strip as `reference.cohesive` reads it, with a deck's held
    values."""
    return dict(coords=arrays["coords"], conn=arrays["blocks"]["qua"]["conn"],
                E=arrays["mats"][0, 0], nu=arrays["mats"][0, 1],
                coh_conn=arrays["blocks"]["coh"]["conn"],
                coh_props=arrays["coh_props"][0], bc_dofs=arrays["bc_dofs"],
                bc_vals=bc_vals, force_dofs=arrays["force_dofs"],
                force_vec=arrays["force_vec"], force_t1=arrays["force_t1"],
                force_t2=arrays["force_t2"], t=arrays["t"], dt=arrays["dt"])


class Entry(DeckEntry):
    def __init__(self, cell, seed: int, device: str, trace: bool):
        tr = cell.traffic
        params = dict(cell.config["params"], t=tr["t"], dt=tr["dt"])
        self.arrays = cohesive_strip(**params)
        self.problem = program.problem(self.arrays)
        # the pulled dofs: the top edge's y dofs hold open_disp, all others 0
        self.pulled = self.arrays["bc_vals"] != 0.0
        super().__init__(cell, seed, device, trace, np.zeros((0, 2)))
        self.config = dataclasses.replace(
            self.config, formulation=tr["formulation"],
            newton_rtol=self.guarantee["rtol"])

    def next_deck(self, warmup: bool = False):
        lo, hi = self.cell.traffic["open_disp"]
        pull = float((self.warm_rng if warmup else self.rng).uniform(lo, hi))
        bc_vals = np.where(self.pulled, pull, 0.0)
        return dict(bc_vals=bc_vals, problem=dataclasses.replace(
            self.problem, bc_vals=bc_vals))

    def run_deck(self, inputs, slot, spans):
        from fem_tpu_torch.solver import stepper

        with span(spans, "run", self.trace):
            return stepper.run(inputs["problem"], self.config)

    def deck_record(self, res):
        finite = bool(np.isfinite(res.aggregate_u).all()
                      and np.isfinite(res.aggregate_stress).all())
        converged = (len(res.newton_converged) == res.nsteps
                     and all(res.newton_converged))
        rec = dict(iters=list(res.krylov_iters), steps=res.nsteps,
                   path=res.path, failed=not (finite and converged))
        if self.trace and res.timers is not None:
            rec["timers"] = dict(res.timers.totals)
        return rec

    def kept(self, inputs, res):
        return dict(bc_vals=inputs["bc_vals"], u=res.aggregate_u,
                    stress=res.aggregate_stress)

    def fine_operator(self):
        return None  # no stencil K2 on this path: no `kua_roofline`

    def compare(self, kept, solve=None):
        """Worst over the kept decks, each max |a - b| / max |b| against the
        float64 reference: u_rel, stress_rel (the quads' nodal-averaged
        stress), gap_rel (the normal and tangential openings of every
        cohesive element at its Gauss points, after the last step); and
        residual_rel, ||K_el u + f_coh(u) - F||_free / ||K_el u||_free of the
        last step at the program's u, in the reference's K and law. With
        `solve` (a control asked for) the reference in float32 takes the
        program's place; `solve` itself, the linear reference, is not
        called."""
        import torch

        values = {}
        for k in kept:
            deck = reference_deck(self.arrays, k["bc_vals"])
            ref = cohesive.run(deck, torch.float64, self.device)
            self.log(f"reference: Newton iterations {ref['newton']}")
            got = k
            if solve is not None:
                got = cohesive.run(deck, torch.float32, self.device)
                self.log(f"control: Newton iterations {got['newton']}")
            compare.worst(values, dict(
                u_rel=compare.rel(got["u"], ref["u"]),
                stress_rel=compare.rel(got["stress"], ref["stress"]),
                gap_rel=compare.rel(
                    cohesive.openings(deck, got["u"], self.device),
                    ref["openings"]),
                residual_rel=_finite(cohesive.residual(deck, got["u"],
                                                       self.device))))
        return values


def _finite(x: float) -> float:
    return x if np.isfinite(x) else compare.WRONG
