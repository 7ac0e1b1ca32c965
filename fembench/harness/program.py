"""What the benchmark takes from the program under test (`fem_tpu_torch`):
its public entries (`models.problem`, `solver.stepper.run`, `io.vtk`), its
`Config`, its phase timers (`StepResult.timers`, `krylov_iters`; in the
profiled decks also as profiler ranges), and the fine stencil operator that
its structured solver applies (`ops.structured`, kernel K2). Imported only
when a run starts, so that the tests of the harness can import it without
the program's CUDA build.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np


def problem(arrays: dict):
    """The program's Problem from a generator's plain arrays."""
    from fem_tpu_torch.models.problem import Block, Problem

    blocks = {name: Block(eltype=name, **{k: np.array(v) for k, v in b.items()})
              for name, b in arrays["blocks"].items()}
    fields = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
              for k, v in arrays.items() if k != "blocks"}
    return Problem(blocks=blocks, **fields)


def config(device: str, guarantee: dict, trace: bool, viscoelastic: bool):
    from fem_tpu_torch.config import Config

    return Config(device=device, dtype=guarantee["dtype"],
                  rtol=guarantee["rtol"], timing=trace,
                  viscoelastic=viscoelastic)


@contextlib.contextmanager
def phase_ranges():
    """While the block runs, each of the program's timer phases
    (`utils.timing.Timers.phase`: setup, rhs, solve or newton, stress) is
    also a profiler range `fembench.phase.<name>` around the whole phase,
    its closing wait for the card included, so that a trace tells the
    kernels of each phase. The phases and their timing are unchanged."""
    import torch
    from fem_tpu_torch.utils import timing

    phase = timing.Timers.phase

    @contextlib.contextmanager
    def ranged(self, name):
        with torch.profiler.record_function(f"fembench.phase.{name}"):
            with phase(self, name):
                yield

    timing.Timers.phase = ranged
    try:
        yield
    finally:
        timing.Timers.phase = phase


def deck_record(res, guarantee: dict, trace: bool) -> dict:
    """The program's own numbers of one deck."""
    finite = bool(np.isfinite(res.aggregate_u).all()
                  and np.isfinite(res.aggregate_stress).all())
    capped = any(i >= guarantee["max_iters"] for i in res.krylov_iters)
    rec = dict(iters=list(res.krylov_iters), steps=res.nsteps,
               path=res.path, failed=not finite or capped)
    if trace and res.timers is not None:
        rec["timers"] = dict(res.timers.totals)
    return rec


def stencil_flops(shape, pdim: int) -> int:
    """Least operations of one K.u on a node grid: a multiply and an add
    for each (node, neighbour) pair and each of the pdim^2 couplings; a node
    has 3 neighbours along an axis inside the grid and 2 at its ends."""
    pairs = math.prod(3 * n - 2 for n in shape)
    return 2 * pdim * pdim * pairs


def fine_operator(prob, device: str):
    """(matvec, ndof, flops, dtype) of the stencil K.u that the structured
    solver applies to this problem, or None where the program does not
    take its stencil path."""
    import torch

    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import structured

    spec = structured.detect(prob)
    if spec is None:
        return None
    system = System(prob, torch.float64, device=device)
    op = structured.operator_for(system, spec)
    return ((lambda u: structured.matvec(op, u)), system.ndof,
            stencil_flops(op.shape, prob.pdim), torch.float64)
