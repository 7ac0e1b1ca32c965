"""solve_ms: the program's `solve` (or `newton`) phase per load step
(ms/step)."""
from fembench.harness.deckstats import per_step_ms


def read(record):
    return per_step_ms(record, ("solve", "newton"))
