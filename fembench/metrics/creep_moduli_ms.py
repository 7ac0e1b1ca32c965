"""creep_moduli_ms: the program's `rhs.creep_moduli` span per load step
(ms/step): `System.creep_moduli`, the batched inverses of the creep
moduli, apart from the rest of the `rhs` and `stress` phases."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "rhs.creep_moduli", per_step=True)
