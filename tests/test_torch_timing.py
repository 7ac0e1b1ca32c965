"""fem_tpu_torch's phase timers and torch.profiler trace (utils/timing.py),
through the stepper and the CLI, on the CPU."""

import json
import os

import pytest
import torch

from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.solver import stepper
from fem_tpu_torch.utils.timing import TRACE_FILE, Timers, device_trace

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
    for name in ("setup", "rhs", "solve", "stress"):
        assert f"  {name} " in out
    trace = json.loads((logdir / TRACE_FILE).read_text())
    assert any(e.get("name", "").startswith("aten::")
               for e in trace["traceEvents"])
    assert (tmp_path / "0_output_000000.vtk").exists()
