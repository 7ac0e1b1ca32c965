"""One run of one cell: set-up, the measured window, the traced extras and
the comparison with the reference, driven by the cell's entry (`Entry` of
`entries/<kind>.py`).

An entry is built from (cell, seed, device, trace) and makes its inputs
from the seed; it has
  next_deck()                 the next deck's inputs (outside the clock)
  run_deck(inputs, slot, spans)  one deck through the program, its results
                              on the host; spans[name] gets the seconds of
                              each layer the entry times itself; slot is
                              None, or the sample slot of a deck that will
                              be compared
  kept(inputs, outputs)       what the comparison needs of a kept deck
  deck_record(outputs)        the program's own numbers of a deck: its
                              Krylov iterations per step, whether it
                              failed, its phase timers
  fine_operator()             (matvec, ndof, flops, dtype) of the K.u the
                              solver applies, or None
  release()                   drop the program's state
  compare(kept_list, solve)   {number: value} against the reference;
                              solve(deck) puts another answer in the
                              program's place (the control)
  close()                     remove what the run wrote
The window is a closed loop with one client: a deck starts when the last
one has returned its results to the host.
"""

from __future__ import annotations

import contextlib
import time
import traceback
from typing import Dict, List

import numpy as np


class Reservoir:
    """A sample of `size` decks of a stream of unknown length, drawn from
    the seed, decided before each deck runs (algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.items: List = [None] * size
        self.seen = 0

    def offer(self):
        """The slot of the next deck, or None if it is not kept."""
        k = self.seen
        self.seen += 1
        if k < self.size:
            return k
        j = int(self.rng.integers(0, k + 1))
        return j if j < self.size else None

    def kept(self):
        return [x for x in self.items if x is not None]


@contextlib.contextmanager
def span(spans: Dict[str, float], name: str, trace: bool):
    """Host seconds of a layer into spans[name]; in a traced run also a
    profiler range `fembench.<name>`."""
    rng = contextlib.nullcontext()
    if trace:
        import torch
        rng = torch.profiler.record_function(f"fembench.{name}")
    t0 = time.perf_counter()
    with rng:
        yield
    spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log) -> dict:
    """The run's record: what the metric readers read, and the numbers
    compared with their limits."""
    import torch

    cuda = device == "cuda"
    if cuda:
        torch.cuda.init()
    t_ctx = time.perf_counter()
    entry = cell.entry_class()(cell, seed, device, trace)
    entry.log = log
    t_inputs = time.perf_counter()
    entry.run_deck(entry.next_deck(warmup=True), None, {})
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    log(f"set-up {setup_s:.3f} s: imports and CUDA context "
        f"{t_ctx - t_start:.3f} s, inputs {t_inputs - t_ctx:.3f} s, warm-up "
        f"deck {t_end - t_inputs:.3f} s")

    tr = cell.traffic
    res = Reservoir(int(tr.get("check_decks", 1)), seed)
    decks, attempted, failed = [], 0, 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        inputs = entry.next_deck()
        slot = res.offer()
        spans: Dict[str, float] = {}
        attempted += 1
        try:
            out = entry.run_deck(inputs, slot, spans)
        except Exception:  # a deck that raises is a failed deck
            failed += 1
            log("deck raised:\n" + traceback.format_exc())
            continue
        rec = entry.deck_record(out)
        rec["spans"] = spans
        decks.append(rec)
        failed += int(rec["failed"])
        if slot is not None:
            res.items[slot] = entry.kept(inputs, out)
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    times = sorted(sum(d["spans"].values()) for d in decks)
    each = " ".join(f"{sum(d['spans'].values()):.3f}" for d in decks)
    log(f"window: {len(decks)} decks in {window_s:.3f} s of wall; decks "
        f"(s): {each}"
        + (f"; median {times[len(times) // 2]:.3f}" if times else ""))

    record = dict(workload=cell.name, config=cell.config, traffic=tr,
                  setup_s=setup_s, window_s=window_s, decks=decks,
                  peak_bytes=peak, profile=None, kua=None)
    if trace:
        record["profile"] = _profile(entry, int(tr.get("profile_decks", 1)),
                                     cuda)
        if cuda:
            record["kua"] = _kua(entry)
    entry.release()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        values = entry.compare(res.kept())
    finally:
        entry.close()
    log(f"comparison with the reference: {time.perf_counter() - t0:.3f} s")
    record.update(attempted=attempted, failed=failed, values=values)
    return record


def _profile(entry, n: int, cuda: bool) -> dict:
    from fembench.harness import profile, program

    def decks():
        return [entry.deck_record(entry.run_deck(entry.next_deck(), None,
                                                 {})) for _ in range(n)]

    with program.phase_ranges():
        out = profile.profile_decks(decks, cuda)
    recs = out.pop("result")
    out["cg_iters"] = sum(sum(r["iters"]) for r in recs)
    out["decks"] = n
    return out


def _kua(entry) -> dict:
    import torch

    from fembench.harness import roofline

    fine = entry.fine_operator()
    if fine is None:
        return None
    matvec, ndof, flops, dtype = fine
    g = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn(ndof, dtype=dtype, device="cuda", generator=g)
    ms = roofline.cold_ms(lambda: matvec(u))
    nbytes = 2 * ndof * torch.finfo(dtype).bits // 8
    b_ms, kind = roofline.bound_ms(nbytes, flops, dtype)
    return dict(cold_ms=ms, ndof=ndof, bytes=nbytes, flops=flops,
                bound_ms=b_ms, bound_by=kind,
                power_limit_w=roofline.power_limit_w())
