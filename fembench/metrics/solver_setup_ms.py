"""solver_setup_ms: the program's `setup.solver` span per deck (ms/deck):
the solver path's set-up; on the structured row the stencil operator and
the multigrid hierarchy (power iterations, the dense coarse inverse)."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "setup.solver")
