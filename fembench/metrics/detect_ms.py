"""detect_ms: the program's `detect` span per deck (ms/deck): the
structured-box detection (`ops/structured.detect`) that runs before the
`setup` phase opens."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "detect")
