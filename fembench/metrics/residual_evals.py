"""residual_evals: the program's Newton residual evaluations, line-search
trials included, per Newton iteration: its counter `newton_residuals` over
its counter `newton_iters` (evals/Newton iteration); None where the program
keeps neither."""
from fembench.harness.spans import window_runs


def read(record):
    runs = [t for _, t in window_runs(record)
            if "newton_residuals" in t.counters]
    iters = sum(t.counters.get("newton_iters", 0) for t in runs)
    if not iters:
        return None
    return sum(t.counters["newton_residuals"] for t in runs) / iters
