"""Nothing that a run imports is JAX or the JAX package (top-level names
compared whole: the port's `fem_tpu_torch` begins with `fem_tpu`), and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from fembench.harness import cli, spec

BANNED = {"jax", "jaxlib", "flax", "fem_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in spec.ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.ROOT / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "itertools", "warnings", "numpy",
                        "torch", "fembench"}, (path, tops)
        assert not any(n.startswith(("fembench.harness", "fembench.entries"))
                       for n in _imports(path)), path


def test_banned_names_are_compared_whole(monkeypatch):
    before = cli.banned_modules()
    monkeypatch.setitem(sys.modules, "fem_tpu_torch.lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert cli.banned_modules() == before
    monkeypatch.setitem(sys.modules, "fem_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"fem_tpu", "jax"} <= set(cli.banned_modules())


def test_a_dry_run_leaves_no_jax_in_sys_modules(tiny):
    """A whole run of the load sweep on the CPU in a fresh process: after
    its window, sys.modules holds nothing of JAX or the JAX package."""
    bench, root = tiny
    code = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(spec.REPO)!r})\n"
        "from fembench.harness import cli, spec\n"
        f"cell = spec.load_cell('hex8-cube-80.load-sweep', "
        f"benchmark=__import__('pathlib').Path({str(bench)!r}), "
        f"root=__import__('pathlib').Path({str(root)!r}))\n"
        "res, _ = cli.execute(cell, 7, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps([res['correct'], cli.banned_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] == 'fem_tpu_torch')[:1]]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=spec.REPO)
    correct, banned, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and banned == [] and port == ["fem_tpu_torch"]
