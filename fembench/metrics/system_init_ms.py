"""system_init_ms: the program's `setup.system` span per deck (ms/deck):
the `System` constructor, its host gathers and its uploads."""
from fembench.harness.spans import span_ms


def read(record):
    return span_ms(record, "setup.system")
