"""Phase timers, the span tree, counters and the profiler trace.

Port of `fem_tpu/utils/timing.py:1-54`. The reference has no tracing or
profiling beyond rank-0 prints (SURVEY.md §5); here every phase of a run is
timed, and `device_trace(logdir)` records a torch.profiler trace of the host
and, on a CUDA machine, of the card. The trace is torch's Chrome trace JSON (open it
in chrome://tracing or Perfetto), not the TensorBoard `jax.profiler` format
fem_tpu writes.

A run's `Timers` holds a tree of spans: its phases (setup, rhs, solve or
newton, stress), the spans beside them (detect, to_host) and the spans
inside them (`setup.system`, `rhs.creep_moduli`, ...). Code below the
stepper opens a span with the module's `span(name)` and counts with
`count(name, n)`; both act on the Timers of the run in progress
(`Timers.active`), and a span outside any run only times itself. The
uploads of host data go through `upload`, which counts their bytes as
`h2d_bytes`. A traced Timers (Config.timing or Config.profile_dir) also
makes each span a profiler range `fem_tpu_torch.<path>` and reads the
allocator's running peak at each span's ends; an untraced one does neither.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import time
from collections import defaultdict
from typing import Deque, Dict, List, Optional, Tuple

import torch

TRACE_FILE = "fem_tpu_torch_trace.json"

_RUN_IDS = itertools.count(1)
_ACTIVE: contextvars.ContextVar[Optional["Timers"]] = contextvars.ContextVar(
    "fem_tpu_torch_timers", default=None)
# the last traced runs' Timers, oldest first: what an observer in the same
# process that holds no StepResult reads of them (a benchmark's metric
# readers, after their window of runs)
_TRACED: Deque["Timers"] = collections.deque(maxlen=1024)


class Span:
    """One interval of a run: name, parent (the enclosing Span, or None at
    the top level), start and end (time.perf_counter), the id of the run
    it belongs to, its counters (its children's included) and, in a traced
    run on a CUDA device, the allocator's running peak at its start and at
    its end (bytes)."""

    __slots__ = ("name", "parent", "start", "end", "run", "counters",
                 "peak", "_range")

    def __init__(self, name: str, parent: Optional["Span"], run: int):
        self.name = name
        self.parent = parent
        self.run = run
        self.counters: Dict[str, int] = {}
        self.peak: Optional[Tuple[int, int]] = None
        self._range = None
        self.start = self.end = float("nan")

    @property
    def path(self) -> str:
        """The dotted names from the top level down, e.g. `setup.solver`."""
        if self.parent is None:
            return self.name
        return f"{self.parent.path}.{self.name}"

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def peak_rise(self) -> int:
        """How far the allocator's running peak rose inside the span
        (bytes; 0 where it was not read)."""
        return 0 if self.peak is None else self.peak[1] - self.peak[0]


class Timers:
    """Accumulating named wall-clock timers and the span tree of one run.

    sync_device: a CUDA device whose work each phase and span waits for at
    its end (torch.cuda.synchronize), so that it holds its device time and
    not only its dispatch; None adds no synchronization.
    traced: each span is also a profiler range `fem_tpu_torch.<path>`, and
    the finished run is kept for `traced_runs`.
    peak_device: a CUDA device whose allocator's running peak a traced
    Timers reads at each span's ends (never resetting it).

    `totals` and `counts` hold the phases alone; `spans` holds every span,
    the phases included, in the order they opened; `counters` the run's
    totals of each counter."""

    def __init__(self, sync_device=None, traced: bool = False,
                 peak_device=None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync_device = sync_device
        self.traced = traced
        self.run_id = next(_RUN_IDS)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open: List[Span] = []
        self._peak_device = peak_device if traced else None

    @contextlib.contextmanager
    def phase(self, name: str):
        """A top-level span whose seconds and count also go to totals and
        counts."""
        s = self._enter(name)
        try:
            yield s
        finally:
            self._exit(s)
            self.totals[name] += s.seconds
            self.counts[name] += 1

    @contextlib.contextmanager
    def span(self, name: str):
        """A child of the innermost open span or phase (a top-level span
        where none is open); yields its Span."""
        s = self._enter(name)
        try:
            yield s
        finally:
            self._exit(s)

    def _enter(self, name: str) -> Span:
        s = Span(name, self._open[-1] if self._open else None, self.run_id)
        self._open.append(s)
        self.spans.append(s)
        if self.traced:
            s._range = torch.profiler.record_function(
                f"fem_tpu_torch.{s.path}")
            s._range.__enter__()
            if self._peak_device is not None:
                s.peak = (torch.cuda.max_memory_allocated(self._peak_device),
                          0)
        s.start = time.perf_counter()
        return s

    def _exit(self, s: Span) -> None:
        if self.sync_device is not None:
            torch.cuda.synchronize(self.sync_device)
        s.end = time.perf_counter()
        if self.traced:
            s._range.__exit__(None, None, None)
            s._range = None
            if s.peak is not None:
                s.peak = (s.peak[0],
                          torch.cuda.max_memory_allocated(self._peak_device))
        self._open.pop()
        up = s.parent.counters if s.parent is not None else self.counters
        for k, v in s.counters.items():
            up[k] = up.get(k, 0) + v

    def count(self, name: str, n: int) -> None:
        """Add n to the counter `name` of the innermost open span."""
        c = self._open[-1].counters if self._open else self.counters
        c[name] = c.get(name, 0) + n

    @contextlib.contextmanager
    def active(self):
        """While the block runs, the module's `span`, `count` and `upload`
        act on this Timers; a traced one is kept for `traced_runs` after."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)
        if self.traced:
            _TRACED.append(self)

    def span_totals(self) -> Dict[str, float]:
        """Seconds per span path, summed over its occurrences."""
        out: Dict[str, float] = defaultdict(float)
        for s in self.spans:
            out[s.path] += s.seconds
        return dict(out)

    def report(self) -> str:
        """The span tree: each path's total, count, counters and peak rise,
        children indented under their parent, siblings by total."""
        rows: Dict[str, list] = {}
        for s in self.spans:
            r = rows.setdefault(s.path, [s.name, 0.0, 0, {}, 0])
            r[1] += s.seconds
            r[2] += 1
            r[4] += s.peak_rise
            for k, v in s.counters.items():
                r[3][k] = r[3].get(k, 0) + v
        kids: Dict[str, List[str]] = defaultdict(list)
        for path in rows:
            kids[path.rpartition(".")[0]].append(path)
        lines: List[str] = []

        def walk(parent: str, depth: int) -> None:
            for path in sorted(kids[parent], key=lambda p: -rows[p][1]):
                name, total, n, counters, rise = rows[path]
                extra = "".join(
                    f"  {k} {_bytes(v) if k.endswith('_bytes') else v}"
                    for k, v in sorted(counters.items()))
                if rise:
                    extra += f"  peak +{_bytes(rise)}"
                lines.append(f"  {'  ' * depth}{name:<{24 - 2 * depth}s} "
                             f"{total:9.3f}s  ({n}x){extra}")
                walk(path, depth + 1)

        walk("", 0)
        return "\n".join(lines)


def _bytes(n: int) -> str:
    return f"{n / 2 ** 20:.1f} MiB"


def span(name: str):
    """`Timers.span` of the run in progress; outside a run a Span that
    times itself and is kept nowhere."""
    tm = _ACTIVE.get()
    if tm is not None:
        return tm.span(name)
    return _lone(name)


@contextlib.contextmanager
def _lone(name: str):
    s = Span(name, None, 0)
    s.start = time.perf_counter()
    try:
        yield s
    finally:
        s.end = time.perf_counter()


def count(name: str, n: int) -> None:
    """`Timers.count` of the run in progress; nothing outside a run."""
    tm = _ACTIVE.get()
    if tm is not None:
        tm.count(name, n)


def upload(a, dtype=None, device=None) -> torch.Tensor:
    """torch.as_tensor(a, dtype=dtype, device=device), its bytes in `dtype`
    counted as `h2d_bytes` of the innermost open span where `a` is host
    data (an array, a list, a number or a CPU tensor)."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if not (isinstance(a, torch.Tensor) and a.device.type != "cpu"):
        count("h2d_bytes", t.nbytes)
    return t


def traced_runs() -> Tuple[Timers, ...]:
    """The Timers of the last traced runs of this process, oldest first."""
    return tuple(_TRACED)


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
