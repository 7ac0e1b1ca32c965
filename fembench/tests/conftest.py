"""Fixtures of the harness's CPU tests: a copy of the benchmark's folder
with its configurations cut to a size the CPU solves in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

# sizes at which the program still takes its structured MG-CG path
TINY = {"hex8-cube-80": dict(nx=12, ny=12, nz=12),
        "make_example-4096x64": dict(x_nels=128, y_nels=16)}


@pytest.fixture
def tiny(tmp_path):
    """(BENCHMARK.json, root) of a copy with the configurations cut to
    TINY."""
    root = tmp_path / "fembench"
    shutil.copytree(REPO / "fembench", root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, params in TINY.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["params"].update(params)
        path.write_text(json.dumps(cfg))
    bench = tmp_path / "BENCHMARK.json"
    shutil.copy(REPO / "BENCHMARK.json", bench)
    return bench, root


@pytest.fixture
def cuda():
    """Skips a test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
