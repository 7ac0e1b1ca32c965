"""inner_ms: the program's `newton.inner` span per load step (ms/step): the
Newton's inner Krylov solves, with the cohesive tangents they form
(`newton.inner.tangent`)."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "newton.inner", per_step=True)
