"""parse_ms: host time of `models.problem.load` per deck (ms/deck)."""
from fembench.harness.deckstats import per_deck_ms


def read(record):
    return per_deck_ms(record, "parse")
