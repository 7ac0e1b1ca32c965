"""fem_tpu_torch's phase timers, span tree, counters and torch.profiler
trace (utils/timing.py), through the stepper and the CLI, on the CPU."""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.solver import stepper
from fem_tpu_torch.utils import timing
from fem_tpu_torch.utils.timing import TRACE_FILE, Timers, device_trace
from fembench.harness import generators, program

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC_DECK = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic",
                            "elastic_test.inp")
COHESIVE_DECK = os.path.join(ROOT, "examples", "ref", "cohesive_test_2.inp")


def test_timers_accumulate_and_report():
    t = Timers()
    for _ in range(2):
        with t.phase("a"):
            pass
    with t.phase("b"):
        sum(range(100000))
    assert t.counts == {"a": 2, "b": 1}
    assert t.totals["b"] > 0.0
    lines = t.report().splitlines()
    assert lines[0].split()[0] == "b" and "(2x)" in lines[1]
    with pytest.raises(RuntimeError):
        with t.phase("c"):
            raise RuntimeError("the phase is still counted")
    assert t.counts["c"] == 1


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(None):  # no logdir: nothing recorded
        pass
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((logdir / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("deck,phase", [(ELASTIC_DECK, "solve"),
                                        (COHESIVE_DECK, "newton")],
                         ids=["elastic", "cohesive"])
def test_step_result_timers_hold_the_phases(deck, phase):
    problem = problem_mod.load(deck)
    msgs = []
    r = stepper.run(problem, Config(device="cpu"), log=msgs.append)
    assert set(r.timers.counts) == {"setup", "rhs", phase, "stress"}
    assert r.timers.counts["setup"] == 1
    assert r.timers.counts[phase] == r.nsteps == r.timers.counts["stress"]
    assert not any("Phase timers" in m for m in msgs)
    stepper.run(problem, Config(device="cpu", timing=True), log=msgs.append)
    assert any(m.startswith("Phase timers:") and "setup" in m for m in msgs)


def test_cli_timing_and_profile_dir(tmp_path, capsys):
    logdir = tmp_path / "trace"
    rc = cli_main(["-f", ELASTIC_DECK, "--device", "cpu", "--timing",
                   "--profile-dir", str(logdir), "-o", f"{tmp_path}/"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Phase timers:" in out
    for name in ("setup", "rhs", "solve", "stress", "to_host"):
        assert f"  {name} " in out
    # children indented under their parent
    assert "\n    system " in out and "\n    solver " in out
    trace = json.loads((logdir / TRACE_FILE).read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    assert (tmp_path / "0_output_000000.vtk").exists()


PHASES = {"setup", "rhs", "solve", "stress"}
# the structured run's spans: path -> parent path
STRUCTURED_TREE = {
    "detect": None, "setup": None, "setup.system": "setup",
    "setup.solver": "setup", "setup.solver.operator": "setup.solver",
    "setup.solver.hierarchy": "setup.solver", "rhs": None, "solve": None,
    "stress": None, "to_host": None}


def test_spans_nest_and_counters_add_up():
    t = Timers()
    with t.phase("a"):
        t.count("n", 1)
        with t.span("b"):
            t.count("n", 2)
            with t.span("c"):
                t.count("n", 4)
        with t.span("b"):
            pass
    with t.span("d"):
        t.count("n", 8)
    t.count("n", 16)  # outside every span: the run's total only
    assert dict(t.totals).keys() == {"a"} and t.counts == {"a": 1}
    assert [s.path for s in t.spans] == ["a", "a.b", "a.b.c", "a.b", "d"]
    assert [s.parent.path if s.parent else None for s in t.spans] == [
        None, "a", "a.b", "a", None]
    a, b, c = t.spans[:3]
    assert (a.counters, b.counters, c.counters) == ({"n": 7}, {"n": 6},
                                                    {"n": 4})
    assert t.counters == {"n": 31}
    assert Counter(s.path for s in t.spans) == {"a": 1, "a.b": 2, "a.b.c": 1,
                                                "d": 1}
    assert t.span_totals()["a"] == t.totals["a"]
    assert all(s.start <= s.end and s.peak is None for s in t.spans)
    lines = t.report().splitlines()
    assert lines[1].startswith("    b ") and "(2x)  n 6" in lines[1]
    assert lines[2].startswith("      c ")


def test_a_span_outside_a_run_times_itself():
    with timing.span("lone") as s:
        timing.count("h2d_bytes", 5)  # no run in progress: dropped
        x = timing.upload(np.zeros(3), dtype=torch.float32)
    assert s.path == "lone" and s.seconds >= 0.0 and s.counters == {}
    assert x.dtype == torch.float32


@pytest.fixture(scope="module")
def box():
    return program.problem(generators.hex_box(12, 12, 12))


def _handed(a, dtype):
    """The bytes of `a` in `dtype`, as the host hands them over."""
    a = a.numpy() if torch.is_tensor(a) else a
    if dtype is None:
        return torch.as_tensor(a).nbytes
    return np.asarray(a, dtype=torch.empty(0, dtype=dtype).numpy().dtype
                      ).nbytes


def test_structured_run_span_tree(box, monkeypatch):
    """The structured run's spans and their parents, one run id, the
    phases alone in totals and counts, and `h2d_bytes` the bytes handed to
    the counting helper, none in detect or to_host."""
    handed = []
    upload = timing.upload

    def counted(a, dtype=None, device=None):
        handed.append(_handed(a, dtype))
        return upload(a, dtype=dtype, device=device)

    monkeypatch.setattr(timing, "upload", counted)
    r = stepper.run(box, Config(device="cpu", timing=True))
    tm = r.timers
    assert r.path == "structured_mg_cg"
    assert {s.path: s.parent.path if s.parent else None
            for s in tm.spans} == STRUCTURED_TREE
    assert {s.run for s in tm.spans} == {tm.run_id}
    assert set(tm.totals) == set(tm.counts) == PHASES
    assert set(tm.span_totals()) == set(STRUCTURED_TREE)
    assert tm.counters["h2d_bytes"] == sum(handed) > 0
    by_path = {s.path: s for s in tm.spans}
    assert "h2d_bytes" not in by_path["detect"].counters
    assert "h2d_bytes" not in by_path["to_host"].counters
    assert by_path["setup.system"].counters["h2d_bytes"] > 0
    assert tm in timing.traced_runs()


@pytest.mark.parametrize("timed", [True, False], ids=["timing", "off"])
def test_spans_are_profiler_ranges_when_timed(timed):
    """With Config.timing each span is a profiler range
    `fem_tpu_torch.<path>`; without it there is none, and the run is not
    kept for traced_runs. Each run has an id of its own."""
    p = program.problem(generators.hex_box(2, 2, 2))
    cfg = Config(device="cpu", solver="cg", timing=timed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = stepper.run(p, cfg)
    b = stepper.run(p, cfg)
    ranges = {e.name for e in prof.events()
              if e.name.startswith("fem_tpu_torch.")}
    assert ranges == ({f"fem_tpu_torch.{p}" for p in STRUCTURED_TREE}
                      if timed else set())
    assert set(a.timers.span_totals()) == set(STRUCTURED_TREE)
    assert a.timers.run_id != b.timers.run_id
    assert a.timers.counters == b.timers.counters
    assert (a.timers in timing.traced_runs()) == timed


def test_creep_moduli_once_a_step():
    arrays = generators.hex_box(4, 4, 4, t=3.0, dt=1.0)
    mats = arrays["mats"].copy()
    mats[:, 2] = 10.0 * mats[:, 0] / (2.0 * (1.0 + mats[:, 1]))
    mats[:, 3] = 1.0
    arrays["mats"] = mats
    r = stepper.run(program.problem(arrays),
                    Config(device="cpu", viscoelastic=True))
    counts = Counter(s.path for s in r.timers.spans)
    assert r.nsteps == 3
    assert counts["rhs.creep_moduli"] == counts["rhs"] == 3
    assert all(s.parent.name == "rhs" for s in r.timers.spans
               if s.name == "creep_moduli")


@pytest.mark.parametrize("inner,threshold", [("jacobi", 20000), ("gmg", 1)])
def test_newton_spans(inner, threshold):
    """The matrix-free Newton's residual, inner solve and line search are
    spans under the `newton` phase; with a hierarchy its set-up's assembly,
    operator and hierarchy are spans under `setup.solver`, and their log
    lines read them."""
    p = meshgen.cohesive_interface_problem(4, 2, open_disp=0.004, t=1.0,
                                           dt=0.5)
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg",
                              amg_threshold=threshold), log=msgs.append)
    counts = Counter(s.path for s in r.timers.spans)
    assert r.path == "cohesive_newton"
    assert set(r.timers.totals) == {"setup", "rhs", "newton", "stress"}
    assert counts["newton.residual"] >= counts["newton"] == r.nsteps
    assert counts["newton.inner"] == counts["newton.linesearch"] == sum(
        r.newton_iters) > 0
    setup = {"setup.solver.assemble", "setup.solver.operator",
             "setup.solver.hierarchy"}
    assert (setup <= set(counts)) == (inner == "gmg")
    assert any(m.strip().startswith("newton wall: inner") for m in msgs)
    assert any("Newton-Krylov set-up" in m for m in msgs) == (inner == "gmg")
