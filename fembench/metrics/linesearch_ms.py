"""linesearch_ms: the program's `newton.linesearch` span per load step
(ms/step): the Newton's backtracking trials, each a residual evaluation."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "newton.linesearch", per_step=True)
