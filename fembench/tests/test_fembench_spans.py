"""The readers of the program's span tree (`harness/spans.py`,
`metrics/{detect_ms,system_init_ms,solver_setup_ms,creep_moduli_ms,
h2d_mib}.py`): a traced run of each cell reads them from the window's decks,
a deck's record keeps the keys it had, and a record whose decks the program
holds no span tree of reads nothing."""

import time

import pytest

from fembench.harness import loop, spec

WORKLOADS = ["hex8-cube-80.load-sweep", "make_example-4096x64.deck-to-vtk",
             "hex8-cube-80.creep-8"]
SPAN_METRICS = ["detect_ms", "system_init_ms", "solver_setup_ms",
                "creep_moduli_ms", "h2d_mib"]
DECK_KEYS = {"iters", "steps", "path", "failed", "spans"}


def _record(tiny, workload, trace, monkeypatch):
    bench, root = tiny
    cell = spec.load_cell(workload, benchmark=bench, root=root)
    # the profiled decks are another test's; these read the window's
    monkeypatch.setattr(loop, "_profile", lambda entry, n, cuda: None)
    return cell, loop.run(cell, 2 ** 33 + 7, 0.2, trace, "cpu",
                          time.perf_counter(), lambda msg: None)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reads_the_span_metrics(tiny, workload, monkeypatch):
    cell, record = _record(tiny, workload, True, monkeypatch)
    assert all(set(d) == DECK_KEYS | {"timers"} for d in record["decks"])
    names = {m["name"] for m in cell.per_layer}
    assert set(SPAN_METRICS) - names == (
        set() if workload.endswith("creep-8") else {"creep_moduli_ms"})
    values = {m: cell.reader(m)(record) for m in names & set(SPAN_METRICS)}
    assert all(v is not None and v > 0 for v in values.values()), values
    # the spans lie inside what host_setup_ms and the setup phase hold
    setup = sum(d["timers"]["setup"] for d in record["decks"]) / len(
        record["decks"])
    assert values["system_init_ms"] + values["solver_setup_ms"] <= (
        1e3 * setup)
    assert values["detect_ms"] + 1e3 * setup <= cell.reader(
        "host_setup_ms")(record)


@pytest.mark.parametrize("workload", WORKLOADS[:1])
def test_untraced_deck_records_keep_their_keys(tiny, workload, monkeypatch):
    cell, record = _record(tiny, workload, False, monkeypatch)
    assert record["decks"] and all(set(d) == DECK_KEYS
                                   for d in record["decks"])
    for m in SPAN_METRICS:
        assert cell.reader(m)(record) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_read_nothing_without_span_trees(metric, monkeypatch):
    """Decks whose runs the program holds no tree of, and a program that
    keeps none (as before its span tree), read None."""
    from fem_tpu_torch.utils import timing

    read = spec.load_cell(WORKLOADS[2]).reader(metric)
    record = {"decks": [dict(iters=[12], steps=1, path="structured_mg_cg",
                             failed=False, spans={"run": 0.5},
                             timers={"setup": 0.25, "rhs": 0.01,
                                     "solve": 0.1, "stress": 0.03})]}
    assert read(record) is None
    monkeypatch.delattr(timing, "traced_runs")
    assert read(record) is None
