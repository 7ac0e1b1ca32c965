"""Shared arithmetic of the readers that average over the window's decks."""


def per_deck_ms(record, span):
    """Mean host milliseconds of a harness span over the window's decks, or
    None where no deck has the span."""
    vals = [d["spans"][span] for d in record["decks"] if span in d["spans"]]
    return 1e3 * sum(vals) / len(vals) if vals else None


def per_step_ms(record, phases):
    """Milliseconds per load step of the program's phase timers (summed over
    `phases`) over the window's decks, or None without timers."""
    decks = [d for d in record["decks"] if "timers" in d]
    steps = sum(d["steps"] for d in decks)
    if not steps:
        return None
    return 1e3 * sum(d["timers"].get(p, 0.0) for d in decks
                     for p in phases) / steps
