"""The harness finds every configuration, traffic mix, entry kind, metric
reader and set of limits by its name; a new cell or metric is new files and
new entries in BENCHMARK.json."""

import json
import time

import pytest

from fembench.harness import cli, spec

BENCH = json.loads((spec.REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves(workload):
    cell = spec.load_cell(workload)
    assert cell.config["guarantee"]["dtype"] == "float64"
    assert (spec.ROOT / "entries" / f"{cell.traffic['entry']}.py").exists()
    assert cell.limits, "a cell needs the limits of its comparison"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"])), m["name"]
    assert "setup_s" in {m["name"] for m in cell.end_to_end}


def test_configs_files_and_paths():
    for c in BENCH["configs"]:
        path = spec.REPO / c["file"]
        assert path.exists() and c["file"].startswith("fembench/")
        assert json.loads(path.read_text())["reduced"] == c["reduced"]
    assert BENCH["command"] == ["python3", "fembench/run.py"]
    assert BENCH["paths"] == ["fembench"]


def test_new_files_add_a_cell_and_a_metric(tiny, monkeypatch):
    """A configuration, a traffic mix, a metric and their cell added as
    files under a copy of the folder, with entries in its BENCHMARK.json,
    run with no edit of any file that was there."""
    bench, root = tiny
    cfg = json.loads((root / "configs" / "hex8-cube-80.json").read_text())
    cfg["params"].update(nx=8, ny=10, nz=12, E=70e9, nu=0.33)
    (root / "configs" / "hex8-slab.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "load-sweep.json").read_text())
    mix.update(load={"scale": [0.9, 1.1], "direction": "base", "per": "deck"},
               profile_decks=1)
    (root / "traffic" / "fixed-direction.json").write_text(json.dumps(mix))
    (root / "metrics" / "decks_done.py").write_text(
        "def read(record):\n    return float(len(record['decks']))\n")
    (root / "checks" / "hex8-slab.fixed-direction.json").write_text(
        json.dumps({"limits": {"u_rel": 1e-6, "stress_rel": 1e-6,
                               "residual_rel": 2e-9}}))
    spec_json = json.loads(bench.read_text())
    spec_json["configs"].append(dict(
        name="hex8-slab", source="https://example.org/slab",
        file="fembench/configs/hex8-slab.json", reduced=[], why="a test"))
    spec_json["workloads"].append(dict(
        name="hex8-slab.fixed-direction", config="hex8-slab",
        traffic="fixed-direction", chips=1, why="a test"))
    spec_json["per_layer"].append(dict(
        name="decks_done", unit="decks", better="higher",
        source="host_clock", layer="harness", moves="deck_s",
        workloads=["hex8-slab.fixed-direction"]))
    bench.write_text(json.dumps(spec_json))
    cell = spec.load_cell("hex8-slab.fixed-direction", benchmark=bench,
                          root=root)
    assert cell.config["params"]["ny"] == 10
    result, _ = cli.execute(cell, 2 ** 40 + 3, 0.5, True, "cpu",
                            time.perf_counter())
    assert result["correct"], result
    assert result["metrics"]["decks_done"]["value"] >= 1
    assert "host_setup_ms" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_program_phases_are_profiler_ranges():
    """In the profiled decks the program's timer phases are profiler ranges,
    and the program's Timers are as they were afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.solver import stepper
    from fem_tpu_torch.utils import timing
    from fembench.harness import generators, program

    phase = timing.Timers.phase
    prob = program.problem(generators.hex_box(12, 12, 12))
    with program.phase_ranges(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        res = stepper.run(prob, Config(device="cpu", timing=True))
    assert res.path == "structured_mg_cg"
    names = {e.name for e in prof.events()}
    assert {"fembench.phase.setup", "fembench.phase.rhs",
            "fembench.phase.solve", "fembench.phase.stress"} <= names
    assert timing.Timers.phase is phase


def test_solve_kernels_are_those_inside_solve_phases():
    from types import SimpleNamespace

    from fembench.harness import profile

    def ev(name, s, e, dev):
        return SimpleNamespace(name=name, dev=dev,
                               time_range=SimpleNamespace(start=s, end=e))

    events = [ev("fembench.run", 0, 100, False),
              ev("fembench.phase.rhs", 1, 10, False),
              ev("fembench.phase.solve", 10, 50, False),
              ev("fembench.phase.solve", 60, 70, False),
              ev("k_rhs", 5, 9, True), ev("k_a", 11, 12, True),
              ev("Memcpy HtoD", 20, 21, True), ev("k_b", 30, 31, True),
              ev("k_stress", 55, 56, True), ev("k_c", 65, 66, True)]
    out = profile.reduce(events, lambda e: e.dev, 1e-4)
    assert out["solve_kernels"] == 3
    assert out["busy_s"] == pytest.approx(9e-6)
