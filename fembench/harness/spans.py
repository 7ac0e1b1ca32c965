"""What the readers of the program's span tree share. The program keeps
the span trees of its last traced runs (`fem_tpu_torch.utils.timing.
traced_runs`: each run's `Timers`); a deck's record copies its run's phase
totals (`timers`), which tell that run's tree among them. A program that
keeps no span tree gives no deck, and its readers read nothing."""


def window_runs(record):
    """The Timers of the window's decks that the program still holds, in
    the window's order, with each deck's record: [(deck, timers)]."""
    from fem_tpu_torch.utils import timing

    traced = getattr(timing, "traced_runs", None)
    if traced is None:
        return []
    by_totals = {tuple(sorted(t.totals.items())): t for t in traced()}
    out = []
    for d in record["decks"]:
        if d.get("timers"):
            t = by_totals.get(tuple(sorted(d["timers"].items())))
            if t is not None:
                out.append((d, t))
    return out


def span_ms(record, path, per_step: bool = False):
    """Milliseconds of the span `path` per deck (per load step with
    per_step), over the decks whose run has it, or None where none has."""
    runs = [(d, t.span_totals()) for d, t in window_runs(record)]
    runs = [(d, s) for d, s in runs if path in s]
    if not runs:
        return None
    per = sum(d["steps"] for d, _ in runs) if per_step else len(runs)
    return 1e3 * sum(s[path] for _, s in runs) / per


def counter_per_deck(record, name):
    """A counter's run total per deck, or None without span trees."""
    runs = window_runs(record)
    if not runs:
        return None
    return sum(t.counters.get(name, 0) for _, t in runs) / len(runs)
