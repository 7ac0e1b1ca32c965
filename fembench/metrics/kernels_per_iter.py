"""kernels_per_iter: CUDA kernels that ran inside the program's solve phases
of the profiled decks (copies and sets left out) over their Krylov
iterations (kernels/iter). Set-up, right-hand side and stress kernels lie
outside those phases and are not counted."""


def read(record):
    p = record.get("profile")
    if not p or not p["solve_kernels"] or not p["cg_iters"]:
        return None
    return p["solve_kernels"] / p["cg_iters"]
