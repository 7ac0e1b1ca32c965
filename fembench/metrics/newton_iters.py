"""newton_iters: the program's Newton iterations per load step, from its
counter `newton_iters` (iters/step); None where the program keeps no such
counter."""
from fembench.harness.spans import window_runs


def read(record):
    runs = [(d, t) for d, t in window_runs(record)
            if "newton_iters" in t.counters]
    if not runs:
        return None
    return (sum(t.counters["newton_iters"] for _, t in runs)
            / sum(d["steps"] for d, _ in runs))
