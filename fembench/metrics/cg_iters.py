"""cg_iters: Krylov iterations per load step, from StepResult.krylov_iters
(iters/step)."""


def read(record):
    iters = [i for d in record["decks"] for i in d["iters"]]
    return sum(iters) / len(iters) if iters else None
