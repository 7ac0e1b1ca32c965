"""What the loop kinds of `fembench/entries/` share: the cell and the run's
options, the program's `Config`, the seeded draw of each deck's load (the
warm-up deck has a stream of its own, so the window's decks do not depend on
it), the program's numbers of a deck, and its fine operator for the
roofline. A kind adds its inputs, its deck, what it keeps of a compared deck
and its comparison (see `harness/loop.py`)."""

from __future__ import annotations

import numpy as np

from fembench.harness import generators, program


class DeckEntry:
    def __init__(self, cell, seed: int, device: str, trace: bool,
                 base_forces, viscoelastic: bool = False):
        self.cell, self.device, self.trace = cell, device, trace
        self.log = lambda msg: None  # the run's log, set by the loop
        self.guarantee = cell.config["guarantee"]
        self.config = program.config(device, self.guarantee, trace,
                                     viscoelastic)
        self.base = np.asarray(base_forces)
        self.rng = np.random.default_rng([seed, 1])
        self.warm_rng = np.random.default_rng([seed, 2])
        self.fine = None

    def draw_forces(self, warmup: bool):
        return generators.draw_forces(self.warm_rng if warmup else self.rng,
                                      self.base, self.cell.traffic["load"])

    def deck_record(self, res):
        return program.deck_record(res, self.guarantee, self.trace)

    def fine_operator_of(self, problem):
        self.fine = program.fine_operator(problem, self.device)
        return self.fine

    def release(self):
        self.fine = None

    def close(self):
        pass
