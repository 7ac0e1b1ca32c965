"""vtk_ms: host time of `io.vtk.write` per deck (ms/deck)."""
from fembench.harness.deckstats import per_deck_ms


def read(record):
    return per_deck_ms(record, "vtk")
