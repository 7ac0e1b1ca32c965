"""Phase timers and the profiler trace.

Port of `fem_tpu/utils/timing.py:1-54`. The reference has no tracing or
profiling beyond rank-0 prints (SURVEY.md §5); here every phase of a run is
timed, and `device_trace(logdir)` records a torch.profiler trace of the host
and, on a CUDA machine, of the card. The trace is torch's Chrome trace JSON (open it
in chrome://tracing or Perfetto), not the TensorBoard `jax.profiler` format
fem_tpu writes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

TRACE_FILE = "fem_tpu_torch_trace.json"


class Timers:
    """Accumulating named wall-clock timers.

    sync_device: a CUDA device whose work each phase waits for at its end
    (torch.cuda.synchronize), so that a phase holds its device time and not
    only its dispatch; None adds no synchronization."""

    def __init__(self, sync_device=None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync_device = sync_device

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync_device is not None:
                torch.cuda.synchronize(self.sync_device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        return "\n".join(
            f"  {name:<24s} {self.totals[name]:9.3f}s  ({self.counts[name]}x)"
            for name in sorted(self.totals, key=self.totals.get,
                               reverse=True))


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """torch.profiler trace (CPU, and CUDA when the machine has it) of the
    block, written to logdir/TRACE_FILE on exit; a no-op without logdir."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
