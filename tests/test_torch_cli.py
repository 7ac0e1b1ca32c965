"""fem_tpu_torch's CLI flags `--precond`, `--shards` and `--devices`: they
parse, reach Config and the writers, and pick the rows fem_tpu's CLI picks."""

import glob
import os
import re

import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.config import Config as JConfig
from fem_tpu_torch import cli
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.parallel import partition
from fem_tpu_torch.solver import stepper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC_DECK = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic",
                            "elastic_test.inp")


def jittered_strip_deck(nx, ny, seed=0):
    """meshgen.quad_strip_deck with every node moved by up to 0.2 of a cell:
    no uniform box, so the unstructured rows take it."""
    lines = meshgen.quad_strip_deck(nx, ny).split("\n")
    first = 4 + nx * ny + 1
    rng = np.random.default_rng(seed)
    for i in range(first, first + (nx + 1) * (ny + 1)):
        x, y = (float(v) for v in lines[i].split())
        dx, dy = 0.2 * rng.uniform(-1, 1, 2)
        lines[i] = f"{x + dx:.6f} {y + dy:.6f}"
    return "\n".join(lines)


@pytest.fixture(scope="module")
def big_deck(tmp_path_factory):
    """A 100 x 100 jittered strip, 20,402 DOFs: above amg_threshold."""
    path = tmp_path_factory.mktemp("deck") / "strip100.inp"
    path.write_text(jittered_strip_deck(100, 100))
    return str(path)


@pytest.mark.parametrize("precond,row", [
    ("jacobi", "unstructured_jacobi_cg"),
    ("amg", "unstructured_amg_or_lattice_gmg_cg"),
    ("auto", "unstructured_amg_or_lattice_gmg_cg"),
])
def test_cli_precond_picks_the_row(big_deck, tmp_path, capsys, precond, row):
    """Above amg_threshold `--precond jacobi` and `--precond amg` take the
    Jacobi and the AMG row, as fem_tpu's CLI picks Jacobi or AMG there, and
    both solve the deck."""
    ndof = problem_mod.load(big_deck).ndof
    assert ndof == 20402 > JConfig().amg_threshold
    assert JConfig(precond=precond).resolve_precond(ndof) == (
        "jacobi" if precond == "jacobi" else "amg")
    out = {}
    run = stepper.run

    def recording_run(problem, config, log=None):
        out["result"] = run(problem, config, log=log)
        return out["result"]

    stepper.run = recording_run
    try:
        rc = cli.main(["-f", big_deck, "--device", "cpu", "--precond",
                       precond, "-o", str(tmp_path) + "/"])
    finally:
        stepper.run = run
    assert rc == 0
    assert out["result"].path == row
    assert f"Solver path: {row}" in capsys.readouterr().out
    assert out["result"].krylov_iters[0] > 0
    assert np.isfinite(out["result"].aggregate_u).all()
    assert (tmp_path / "0_output_000000.vtk").exists()


def test_cli_precond_jacobi_vtk_byte_identical_to_fem_tpu(tmp_path,
                                                          monkeypatch):
    """On the Jacobi-CG path the VTK equals fem_tpu's byte for byte with
    the flag given, as without it (tests/test_torch_slice.py)."""
    args = ["-f", ELASTIC_DECK, "-q", "--solver", "cg", "--precond", "jacobi"]
    for name, main, extra in (("jax", j_cli_main, []),
                              ("torch", cli.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(args + extra) == 0
    assert ((tmp_path / "torch" / "0_output_000000.vtk").read_bytes()
            == (tmp_path / "jax" / "0_output_000000.vtk").read_bytes())


@pytest.mark.parametrize("argv,expect", [
    ([], dict(precond="auto", n_devices=None)),
    (["--precond", "amg"], dict(precond="amg", n_devices=None)),
    (["--precond", "jacobi", "--devices", "4"],
     dict(precond="jacobi", n_devices=4)),
    (["--devices", "1"], dict(n_devices=None)),
    (["--devices", "0", "--shards", "3"], dict(n_devices=None)),
])
def test_cli_flags_reach_config_and_writers(tmp_path, monkeypatch, argv,
                                            expect):
    seen = {}
    run = stepper.run

    def recording_run(problem, config, log=None):
        seen["config"] = config
        return run(problem, config, log=log)

    def recording_writer(problem, stress, u, nparts, prefix=""):
        seen["shards"] = (nparts, prefix)
        return []

    monkeypatch.setattr(stepper, "run", recording_run)
    monkeypatch.setattr(partition, "write_sharded_vtk", recording_writer)
    prefix = str(tmp_path) + "/"
    assert cli.main(["-f", ELASTIC_DECK, "--device", "cpu", "-q", "-o",
                     prefix, *argv]) == 0
    for key, value in expect.items():
        assert getattr(seen["config"], key) == value
    if "--shards" in argv:
        assert seen["shards"] == (3, prefix)
        assert not (tmp_path / "0_output_000000.vtk").exists()
    else:
        assert "shards" not in seen
        assert (tmp_path / "0_output_000000.vtk").exists()


def test_cli_rejects_unknown_precond():
    with pytest.raises(SystemExit):
        cli.main(["-f", ELASTIC_DECK, "--device", "cpu", "--precond", "ilu"])


def test_new_modules_and_chip_smoke_leave_jax_out():
    """No module of the package, the new parallel/ included, nor
    chip_smoke.py nor a tools/torch_*.py script imports jax or fem_tpu."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|fem_tpu\b(?!_torch)|.*pallas)",
                     re.M)
    paths = glob.glob(os.path.join(ROOT, "fem_tpu_torch", "**", "*.py"),
                      recursive=True)
    names = {os.path.relpath(p, ROOT) for p in paths}
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/commcount.py", "parallel/ops.py",
                "parallel/partition.py"):
        assert os.path.join("fem_tpu_torch", rel) in names
    paths += [os.path.join(ROOT, "chip_smoke.py")]
    paths += glob.glob(os.path.join(ROOT, "tools", "torch_*.py"))
    for path in paths:
        assert not pat.search(open(path).read()), path
