"""The comparison that decides `correct`: the program's results of the kept
decks against the plain reference (`fembench.reference`) run on the same
inputs, which the benchmark made. Each number is the worst over the kept
decks; the limits are in `checks/<workload>.json`.
"""

from __future__ import annotations

import numpy as np


WRONG = 1e300  # the reading of an answer of another shape, or not finite


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape:
        return WRONG
    r = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    return r if np.isfinite(r) else WRONG


def residual(ref: dict) -> float:
    """The reference's reading of a judged increment's true relative
    residual (`reference.run(..., judge_du=...)`)."""
    r = float(ref["residual"])
    return r if np.isfinite(r) else WRONG


def reference_deck(arrays: dict, forces, creep: bool) -> dict:
    """A generator's arrays as the reference reads them (one block, one
    material), with a deck's force records."""
    (block,) = arrays["blocks"].values()
    mat = arrays["mats"][0]
    return dict(coords=arrays["coords"], conn=block["conn"], E=mat[0],
                nu=mat[1], visc=mat[2], expn=mat[3], creep=creep,
                bc_dofs=arrays["bc_dofs"], bc_vals=arrays["bc_vals"],
                force_dofs=arrays["force_dofs"], force_vec=forces,
                force_t1=arrays["force_t1"], force_t2=arrays["force_t2"],
                t=arrays["t"], dt=arrays["dt"])


def worst(values: dict, new: dict) -> dict:
    for k, v in new.items():
        values[k] = max(values.get(k, 0.0), v)
    return values


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or without a value, fails."""
    rows = [(k, values.get(k), limits.get(k))
            for k in sorted(set(values) | set(limits))]
    ok = bool(rows) and all(v is not None and lim is not None and v <= lim
                            for _, v, lim in rows)
    return ok, rows
