"""system_ms: the program's `rhs` and `stress` phases per load step
(ms/step): the load vector with its creep term, the stress recovery or the
creep update."""
from fembench.harness.deckstats import per_step_ms


def read(record):
    return per_step_ms(record, ("rhs", "stress"))
