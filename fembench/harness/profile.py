"""Reduction of a torch.profiler trace (CPU and CUDA activities) of whole
decks to the device layer's numbers: the time in which any operation ran on
the card (the union of its kernels, copies and sets), the kernels that ran
inside the program's solve phases, the device time by operation, and the
idle gaps by what the host was doing.

The arithmetic is that of `tools/torch_profile_solve.py` (device rows of
the profile, copies and sets apart from kernels), taken from the events'
time ranges so that overlapping work on the card is counted once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

SPAN_PREFIX = "fembench."
# the program's solve phases as ranges (`program.phase_ranges`)
SOLVE_PHASES = ("fembench.phase.solve", "fembench.phase.newton")
TOP = 10


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(intervals: List[Tuple[float, float, str]]):
    """The events that no other contains, sorted by start."""
    top: List[Tuple[float, float, str]] = []
    for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if not top or s >= top[-1][1]:
            top.append((s, e, name))
    return top


def _at(top, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and top[i][0] <= t < top[i][1]:
        return top[i][2]
    return None


def reduce(events, is_device, wall_s: float) -> Dict:
    """events: profiler FunctionEvents; is_device(e) tells the card's from
    the host's. Returns busy_s, window_s (the host's wall over the profiled
    decks), solve_kernels (kernels, copies and sets apart, that start inside
    a solve phase: the phase ends by waiting for the card, so its kernels
    run inside it), device_ops and idle_gaps ([name, seconds], the TOP
    largest)."""
    dev, host = [], []
    for e in events:
        iv = (e.time_range.start, e.time_range.end, e.name)
        if not is_device(e):
            host.append(iv)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(SPAN_PREFIX)):
            # the card's side of a `fembench.*` range is no device work
            dev.append(iv)
    busy = _union([(s, e) for s, e, _ in dev])
    solve = [(s, e, True) for s, e in
             _union([(s, e) for s, e, name in host if name in SOLVE_PHASES])]
    solve_starts = [s for s, _, _ in solve]
    by_op: Dict[str, float] = defaultdict(float)
    solve_kernels = 0
    for s, e, name in dev:
        by_op[name] += (e - s) * 1e-6
        if (not name.startswith(("Memcpy", "Memset"))
                and _at(solve, solve_starts, s)):
            solve_kernels += 1
    spans = _outermost([iv for iv in host if iv[2].startswith(SPAN_PREFIX)])
    ops = _outermost([iv for iv in host
                      if not iv[2].startswith(SPAN_PREFIX)
                      and not iv[2].startswith("ProfilerStep")])
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in ops]
    lo = min([s for s, _, _ in spans] + [iv[0] for iv in busy[:1]],
             default=0.0)
    hi = max([e for _, e, _ in spans] + [iv[1] for iv in busy[-1:]],
             default=0.0)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        span = _at(spans, span_starts, mid) or "outside the decks"
        op = _at(ops, op_starts, mid) or "python"
        gaps[f"{span} / {op}"] += (e - s) * 1e-6
    return dict(
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=wall_s,
        solve_kernels=solve_kernels,
        device_ops=sorted(([k[:160], v] for k, v in by_op.items()),
                          key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(([k[:160], v] for k, v in gaps.items()),
                         key=lambda kv: -kv[1])[:TOP],
    )


def profile_decks(run, cuda: bool = True) -> Dict:
    """Run `run()` (whole decks, each in its `fembench.*` spans) under
    torch.profiler and reduce its trace; on the CPU the host alone is
    traced and no device event is found."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    red = reduce(prof.events(), lambda e: e.device_type != DeviceType.CPU,
                 wall)
    red["result"] = out
    return red
