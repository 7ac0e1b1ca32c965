"""deck_s: the window's whole wall time, from its start to the end of its
last deck, over the decks it completed (s)."""


def read(record):
    n = len(record["decks"])
    return record["window_s"] / n if n else None
