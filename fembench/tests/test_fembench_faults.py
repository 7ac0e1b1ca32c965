"""A run with the timed path broken underneath comes out not correct, for
each fault that the cell can have, and so does the control (the reference
in the program's place, in float32): the harness's look for a card is
skipped and the rest of a run is driven on the CPU at a tiny size."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from fembench import control, reference
from fembench.harness import cli, compare, spec

WORKLOADS = ["hex8-cube-80.load-sweep", "make_example-4096x64.deck-to-vtk",
             "hex8-cube-80.creep-8"]


def _run(tiny, workload):
    bench, root = tiny
    cell = spec.load_cell(workload, benchmark=bench, root=root)
    result, rows = cli.execute(cell, 2 ** 36 + 1, 0.2, False, "cpu",
                               time.perf_counter())
    return result


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tiny, workload):
    assert _run(tiny, workload)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_answer_altered_where_produced(tiny, workload, monkeypatch):
    """stepper.run returns u with one entry off by a hundredth of u's
    largest entry."""
    from fem_tpu_torch.solver import stepper

    run = stepper.run

    def altered(problem, config=None, log=None):
        res = run(problem, config, log)
        u = res.aggregate_u.copy()
        u[u.shape[0] // 3] += 1e-2 * np.abs(u).max()
        return dataclasses.replace(res, aggregate_u=u)

    monkeypatch.setattr(stepper, "run", altered)
    result = _run(tiny, workload)
    assert not result["correct"]
    assert result["checks"]["u_rel"]["value"] > result["checks"]["u_rel"][
        "limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_solve_stopped_early(tiny, workload):
    """The program's solves stopped at a relative tolerance of 1e-6 instead
    of the configuration's 1e-9: the true residual of its answer fails."""
    bench, root = tiny
    cell = control.loosened(spec.load_cell(workload, benchmark=bench,
                                           root=root), 1e-6)
    result, _ = cli.execute(cell, 2 ** 36 + 1, 0.2, False, "cpu",
                            time.perf_counter())
    assert not result["correct"]
    assert result["checks"]["residual_rel"]["value"] > result["checks"][
        "residual_rel"]["limit"]


def test_creep_step_returns_its_state_unchanged(tiny, monkeypatch):
    from fem_tpu_torch.models.system import System

    monkeypatch.setattr(System, "creep_stress_update",
                        lambda self, state, du, moduli: state)
    assert not _run(tiny, "hex8-cube-80.creep-8")["correct"]


def test_strip_parse_altered(tiny, monkeypatch):
    from fem_tpu_torch.models import problem as problem_mod

    load = problem_mod.load

    def altered(text, backend="auto"):
        p = load(text, backend)
        p.force_vec = p.force_vec * (1.0 + 1e-12)
        return p

    monkeypatch.setattr(problem_mod, "load", altered)
    result = _run(tiny, "make_example-4096x64.deck-to-vtk")
    assert not result["correct"]
    assert result["checks"]["parse_diff"]["value"] >= 1


def test_strip_vtk_altered(tiny, monkeypatch):
    from fem_tpu_torch.io import vtk

    write = vtk.write

    def altered(path, coords, cells, stress, displacements):
        write(path, coords, cells, 1.01 * stress, displacements)

    monkeypatch.setattr(vtk, "write", altered)
    result = _run(tiny, "make_example-4096x64.deck-to-vtk")
    assert not result["correct"]
    assert result["checks"]["vtk_stress_rel"]["value"] > result["checks"][
        "vtk_stress_rel"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(tiny, workload):
    """The float32 reference in the program's place fails a number."""
    bench, root = tiny
    cell = spec.load_cell(workload, benchmark=bench, root=root)
    entry = cell.entry_class()(cell, 2 ** 36 + 5, "cpu", False)
    inputs = entry.next_deck()
    out = entry.run_deck(inputs, 0, {})
    try:
        values = entry.compare([entry.kept(inputs, out)], solve=lambda d: (
            reference.run(d, torch.float32)))
    finally:
        entry.close()
    ok, rows = compare.judge(values, cell.limits)
    assert not ok, rows
