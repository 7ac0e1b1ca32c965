"""Deck to VTK: per deck the calls that `fem_tpu_torch.cli.main` makes after
its arguments, in its order: `models.problem.load(text, backend="native")`
on the deck text (made from the seed outside the clock),
`solver.stepper.run`, and `io.vtk.write(..., vtk.cells_in_deck_order(
problem), ...)`. The text of a deck that is not compared goes to
`os.devnull`; a compared deck's file is written under TMPDIR and read back.
The warm-up deck of the set-up parses and solves but writes no VTK: the
writer is Python and has nothing to build or warm.

Traffic keys: `load` (generators.draw_forces on the deck's force records),
`check_decks`, `profile_decks`. The configuration's generator is the
make_example strip (`strip_deck`, `strip_forces`).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from fembench import reference
from fembench.harness import compare, generators
from fembench.harness.entry import DeckEntry
from fembench.harness.loop import span
from fembench.reference import deck as ref_deck


class Entry(DeckEntry):
    def __init__(self, cell, seed: int, device: str, trace: bool):
        super().__init__(cell, seed, device, trace, generators.STRIP_FORCES)
        p = cell.config["params"]
        self.nx, self.ny = p["x_nels"], p["y_nels"]
        self.body = generators.strip_deck(self.nx, self.ny)
        self.tmp = tempfile.mkdtemp(prefix="fembench-")
        self.last_problem = None

    def next_deck(self, warmup: bool = False):
        return dict(text=self.body + generators.strip_forces(
            self.nx, self.ny, self.draw_forces(warmup)), warmup=warmup)

    def run_deck(self, inputs, slot, spans):
        from fem_tpu_torch.io import vtk
        from fem_tpu_torch.models import problem as problem_mod
        from fem_tpu_torch.solver import stepper

        path = (os.devnull if slot is None else
                os.path.join(self.tmp, f"deck{slot}.vtk"))
        with span(spans, "parse", self.trace):
            prob = problem_mod.load(inputs["text"], backend="native")
        with span(spans, "run", self.trace):
            res = stepper.run(prob, self.config)
        if not inputs["warmup"]:  # the writer is Python: nothing to warm
            with span(spans, "vtk", self.trace):
                vtk.write(path, prob.coords, vtk.cells_in_deck_order(prob),
                          res.aggregate_stress, res.aggregate_u)
        self.last_problem = prob
        return dict(problem=prob, res=res, path=path)

    def deck_record(self, out):
        return super().deck_record(out["res"])

    def kept(self, inputs, out):
        prob, res = out["problem"], out["res"]
        (block,) = prob.blocks.values()
        order = np.argsort(block.eids, kind="stable")
        parsed = dict(
            stype=prob.stype, pdim=prob.pdim, t=prob.t, dt=prob.dt,
            etype=block.eltype, coords=prob.coords, conn=block.conn[order],
            mat=block.mat[order], mats=prob.mats, bc_dofs=prob.bc_dofs,
            bc_vals=prob.bc_vals, force_dofs=prob.force_dofs,
            force_vec=prob.force_vec, force_t1=prob.force_t1,
            force_t2=prob.force_t2)
        return dict(text=inputs["text"], parsed=parsed, u=res.aggregate_u,
                    du=res.du, stress=res.aggregate_stress, vtk=out["path"])

    def fine_operator(self):
        return self.fine_operator_of(self.last_problem)

    def release(self):
        super().release()
        self.last_problem = None

    def compare(self, kept, solve=None):
        """Worst over the kept decks of: parse_diff, the deck's fields on
        which the program's parse and the reference's differ (exact);
        u_rel and stress_rel against the reference's solve; vtk_mesh_diff,
        the written points, cells and types that differ from the reference's
        mesh (exact); vtk_u_rel and vtk_stress_rel, the written fields
        against the reference's; residual_rel, the true relative residual
        of the program's answer in the reference's system."""
        import torch

        values = {}
        for k in kept:
            ref_in = ref_deck.parse(k["text"])
            deck = dict(ref_in, E=ref_in["mats"][0, 0],
                        nu=ref_in["mats"][0, 1], creep=False)
            got, path = k, k["vtk"]
            if solve:  # the control's answer, written by the same writer
                got, path = solve(deck), os.path.join(self.tmp, "control.vtk")
                _write_vtk(path, ref_in, got)
            ref = reference.run(deck, torch.float64, self.device,
                                judge_du=got["du"])
            self.log(f"reference: iterations {ref['iters']}")
            pdim = ref_in["pdim"]
            nn = ref["u"].shape[0] // pdim
            w = ref_deck.read_vtk(path)
            pts = np.zeros((nn, 3))
            pts[:, :pdim] = ref_in["coords"]
            mesh_diff = sum((
                not _same(w["points"], np.round(pts, 3)),
                not _same(w["cells"], ref_in["conn"]),
                not _same(w["cell_types"],
                          np.full(ref_in["conn"].shape[0],
                                  ref_deck.VTK_TYPE[ref_in["etype"]])),
                bool(np.any(w["displacements"][:, pdim:] != 0.0))))
            compare.worst(values, dict(
                parse_diff=float(sum(not _same(k["parsed"][f], ref_in[f])
                                     for f in k["parsed"])),
                u_rel=compare.rel(got["u"], ref["u"]),
                stress_rel=compare.rel(got["stress"], ref["stress"]),
                residual_rel=compare.residual(ref),
                vtk_mesh_diff=float(mesh_diff),
                vtk_u_rel=compare.rel(
                    w["displacements"][:, :pdim].reshape(-1), ref["u"]),
                vtk_stress_rel=compare.rel(w["stress"], ref["stress"])))
        return values

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def _write_vtk(path, ref_in, got):
    """An answer in place of the program's, through the program's writer."""
    from fem_tpu_torch.io import vtk

    cell_type = ref_deck.VTK_TYPE[ref_in["etype"]]
    vtk.write(path, ref_in["coords"], [(cell_type, c) for c in ref_in["conn"]],
              got["stress"], got["u"])


def _same(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))
