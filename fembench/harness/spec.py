"""Discovery: everything that belongs to one configuration, traffic mix,
entry kind, metric or cell is found by its name.

    BENCHMARK.json                  the cells and the metrics
    <root>/configs/<config>.json    a configuration
    <root>/traffic/<traffic>.json   a traffic mix; its `entry` names the loop
    <root>/entries/<entry>.py       a loop kind: a class `Entry`
    <root>/metrics/<metric>.py      a metric: a function `read(record)`
    <root>/checks/<workload>.json   the limits of a cell's comparison

`<root>` is the benchmark's folder (`fembench/`). A later cell, mix or
metric is new files and new entries in BENCHMARK.json, with no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def entry_class(self):
        return _module(self.root / "entries" / f"{self.traffic['entry']}.py",
                       f"fembench_entry_{self.traffic['entry']}").Entry

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return _module(self.root / "metrics" / f"{metric}.py",
                       f"fembench_metric_{metric}").read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, benchmark: Optional[Path] = None,
              root: Path = ROOT) -> Cell:
    """The cell named `workload`, from BENCHMARK.json (by default the one at
    the root of the checkout) and the files under `root`."""
    spec = _json(benchmark or REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    checks = root / "checks" / f"{workload}.json"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(root / "configs" / f"{w['config']}.json"),
        traffic=_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_json(checks)["limits"] if checks.exists() else {},
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        root=root)
