"""fem_tpu_torch host layer against fem_tpu: deck parsing, Problem, meshgen,
VTK bytes, Config, smallmat, and the package's independence from JAX."""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fem_tpu.io import inp as j_inp
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.io import vtk as j_vtk
from fem_tpu.models import problem as j_problem
from fem_tpu.utils import smallmat as j_smallmat
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import inp, meshgen, vtk
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.system import System
from fem_tpu_torch.utils import smallmat

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = sorted(
    glob.glob(os.path.join(ROOT, "examples", "*.inp"))
    + glob.glob(os.path.join(ROOT, "examples", "ref", "**", "*.inp"),
                recursive=True)
)


def assert_same(a, b, path="obj"):
    """Field-by-field equality of two parsed objects (dataclasses, dicts,
    lists, arrays, scalars) from the two packages."""
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for n in names:
            assert_same(getattr(a, n), getattr(b, n), f"{path}.{n}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert a == b and type(a) is type(b), path


def test_deck_list_covers_examples():
    assert len(DECKS) == 9


@pytest.mark.parametrize("deck", DECKS, ids=lambda p: os.path.relpath(p, ROOT))
def test_deck_parses_like_fem_tpu(deck):
    d_ref = j_inp.parse(deck)
    d = inp.parse(deck)
    assert_same(d, d_ref)
    assert_same(problem_mod.Problem.from_deck(d),
                j_problem.Problem.from_deck(d_ref))
    assert_same(problem_mod.load(deck),
                j_problem.load(deck, backend="python"))


def test_constraint_equations_rejected_like_fem_tpu():
    text = open(os.path.join(ROOT, "examples", "ref", "el_test.inp")).read()
    lines = text.splitlines()
    counts = lines[2].split("!")[0].split()
    counts[4] = "1"  # nceqs (8-count header)
    lines[2] = " ".join(counts)
    bad = "\n".join(lines) + "\n"
    with pytest.raises(NotImplementedError):
        j_inp.parse(bad)
    with pytest.raises(NotImplementedError, match="nceqs"):
        inp.parse(bad)


def test_native_parser_not_ported():
    with pytest.raises(NotImplementedError, match="A.8"):
        problem_mod.load(DECKS[0], backend="native")


@pytest.mark.parametrize("kw", [
    dict(nx=3, ny=2, nz=4),
    dict(nx=4, ny=3, nz=2, lx=1.0, jitter=0.3, seed=5),
    dict(nx=12, ny=12, nz=12, lx=1.0, ly=1.0, lz=1.0),
])
def test_hex_box_problem_equal(kw):
    ref = j_meshgen.hex_box_problem(**kw)
    assert_same(meshgen.hex_box_problem(**kw), ref)
    assert_same(problem_mod.Problem.from_reference(ref), ref)


def test_quad_builders_equal():
    kw = dict(nx=4, ny=3, lx=2.0, tip_force=(1.0, -2.0))
    assert_same(meshgen.quad_grid_problem(**kw),
                j_meshgen.quad_grid_problem(**kw))
    assert meshgen.quad_strip_deck(10, 3) == j_meshgen.quad_strip_deck(10, 3)


def test_vtk_bytes_identical(tmp_path):
    rng = np.random.default_rng(0)
    p = problem_mod.load(os.path.join(ROOT, "examples", "ref",
                                      "lin_two_quads_qs.inp"))
    jp = j_problem.load(os.path.join(ROOT, "examples", "ref",
                                     "lin_two_quads_qs.inp"), backend="python")
    # small magnitudes exercise the F0.d sign/leading-zero rules
    stress = rng.standard_normal((p.nnds, 3)) * np.array([1e-9, 1.0, 1e4])
    disp = rng.standard_normal(p.ndof) * 1e-3
    cells = vtk.cells_in_deck_order(p)
    assert_same(cells, j_vtk.cells_in_deck_order(jp))
    vtk.write(str(tmp_path / "a.vtk"), p.coords, cells, stress, disp)
    j_vtk.write(str(tmp_path / "b.vtk"), jp.coords,
                j_vtk.cells_in_deck_order(jp), stress, disp)
    assert (tmp_path / "a.vtk").read_bytes() == (tmp_path / "b.vtk").read_bytes()
    for x, y in zip(vtk.read_fields(str(tmp_path / "a.vtk")),
                    j_vtk.read_fields(str(tmp_path / "b.vtk"))):
        assert np.array_equal(x, y)


def test_import_leaves_jax_out():
    """Importing every module of the package imports no JAX and no fem_tpu,
    and sets no torch default dtype."""
    code = (
        "import importlib, pkgutil, sys, torch, fem_tpu_torch\n"
        "for m in pkgutil.walk_packages(fem_tpu_torch.__path__, "
        "'fem_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fem_tpu' or m.startswith('fem_tpu.')]\n"
        "assert not bad, bad\n"
        "assert torch.get_default_dtype() == torch.float32\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    pat = re.compile(r"^\s*(from|import)\s+(jax|fem_tpu\b(?!_torch)|.*pallas)",
                     re.M)
    for path in glob.glob(os.path.join(ROOT, "fem_tpu_torch", "**", "*.py"),
                          recursive=True):
        assert not pat.search(open(path).read()), path


@pytest.mark.parametrize("kw,item", [
    (dict(viscoelastic=True), "A.8"),
    (dict(n_devices=2), "A.9"),
    (dict(checkpoint_dir="ckpt"), "A.8"),
    (dict(profile_dir="trace"), "A.8"),
])
def test_config_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Config(device="cpu", **kw)


def test_config_accepts_amg_precond():
    c = Config(device="cpu", precond="amg", gmg_min=1)
    assert c.resolve_precond(10) == "amg" and c.gmg_min == 1
    assert Config(device="cpu").gmg_min == 20000
    assert Config(device="cpu").resolve_precond(20000) == "amg"
    assert Config(device="cpu").resolve_precond(19999) == "jacobi"


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    assert Config().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        Config().torch_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        System(meshgen.hex_box_problem(1, 1, 1), device="cuda")


def test_smallmat_matches_fem_tpu():
    rng = np.random.default_rng(3)
    for d in (2, 3):
        a = np.eye(d) + 0.3 * rng.standard_normal((5, 4, d, d))
        t = torch.as_tensor(a)
        np.testing.assert_allclose(smallmat.det(t).numpy(),
                                   np.asarray(j_smallmat.det(a)), rtol=1e-14)
        np.testing.assert_allclose(smallmat.inv(t).numpy(),
                                   np.asarray(j_smallmat.inv(a)), rtol=1e-13)
    p = rng.standard_normal((4, 6, 3))
    tp = [torch.as_tensor(x) for x in p]
    np.testing.assert_allclose(smallmat.quad_area3d(*tp).numpy(),
                               np.asarray(j_smallmat.quad_area3d(*p)),
                               rtol=1e-14)
    np.testing.assert_allclose(smallmat.magnitude(tp[0]).numpy(),
                               np.asarray(j_smallmat.magnitude(p[0])),
                               rtol=1e-14)
