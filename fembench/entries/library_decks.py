"""Library decks: one mesh from the configuration's generator, and per deck
a fresh `fem_tpu_torch.solver.stepper.run(problem, Config(...))` with the
deck's load swapped in (`dataclasses.replace`, outside the clock), as a
user's sweep script calls the library.

Traffic keys: `load` (generators.draw_forces), optional `t` and `dt` (the
load steps), optional `creep` ({"visc_over_G": ..., "expn": ...}: the
material's viscosity as a multiple of its shear modulus, so a relaxation
time of that many time units), `check_decks`, `profile_decks`.
"""

from __future__ import annotations

import dataclasses

from fembench import reference
from fembench.harness import compare, generators, program
from fembench.harness.entry import DeckEntry
from fembench.harness.loop import span


def make_arrays(config: dict, traffic: dict) -> dict:
    """The configuration's mesh with the mix's time steps and material."""
    params = dict(config["params"])
    for key in ("t", "dt"):
        if key in traffic:
            params[key] = traffic[key]
    arrays = getattr(generators, config["generator"])(**params)
    creep = traffic.get("creep")
    if creep:
        mats = arrays["mats"].copy()
        shear = mats[:, 0] / (2.0 * (1.0 + mats[:, 1]))
        mats[:, 2] = creep["visc_over_G"] * shear
        mats[:, 3] = creep["expn"]
        arrays["mats"] = mats
    return arrays


class Entry(DeckEntry):
    def __init__(self, cell, seed: int, device: str, trace: bool):
        self.creep = bool(cell.traffic.get("creep"))
        self.arrays = make_arrays(cell.config, cell.traffic)
        self.problem = program.problem(self.arrays)
        super().__init__(cell, seed, device, trace, self.arrays["force_vec"],
                         self.creep)

    def next_deck(self, warmup: bool = False):
        forces = self.draw_forces(warmup)
        return dict(forces=forces,
                    problem=dataclasses.replace(self.problem,
                                                force_vec=forces))

    def run_deck(self, inputs, slot, spans):
        from fem_tpu_torch.solver import stepper

        with span(spans, "run", self.trace):
            return stepper.run(inputs["problem"], self.config)

    def kept(self, inputs, res):
        return dict(forces=inputs["forces"], u=res.aggregate_u,
                    du=res.du, stress=res.aggregate_stress)

    def fine_operator(self):
        return self.fine_operator_of(self.problem)

    def compare(self, kept, solve=None):
        """Worst over the kept decks of u_rel and stress_rel against the
        float64 reference, and residual_rel, the true relative residual of
        the last load step's increment in the reference's system of that
        step. `solve` puts another solver's answer in the program's place
        (the control)."""
        import torch

        values = {}
        for k in kept:
            deck = compare.reference_deck(self.arrays, k["forces"],
                                          self.creep)
            got = solve(deck) if solve else k
            ref = reference.run(deck, torch.float64, self.device,
                                judge_du=got["du"])
            self.log(f"reference: iterations {ref['iters']}")
            compare.worst(values, dict(
                u_rel=compare.rel(got["u"], ref["u"]),
                stress_rel=compare.rel(got["stress"], ref["stress"]),
                residual_rel=compare.residual(ref)))
        return values
