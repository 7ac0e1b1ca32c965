"""fem_tpu_torch's binding of the native mesh engine (native/libfemmesh.so)
against the port's Python parser and fem_tpu's binding (port of
tests/test_native.py): deck parsing field for field, Morton ordering, RCB
partitioning, the load dispatch and Problem.from_flat."""

import os

import numpy as np
import pytest

from fem_tpu.io import native as j_native
from fem_tpu.models import problem as j_problem
from fem_tpu_torch.io import inp, meshgen, native
from fem_tpu_torch.models import problem as problem_mod

from tests.test_torch_host import assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "examples", "ref")
DECKS = [
    f"{REF}/SNES_test/elastic/elastic_test.inp",
    f"{REF}/cohesive_test_2.inp",
    f"{REF}/lin_two_quads_qs.inp",
    f"{REF}/SNES_test/cohesive_test/cohesive_test_2.inp",
]


def test_library_is_built():
    assert native.available(), "native/libfemmesh.so does not load"


@pytest.mark.parametrize("deck", DECKS, ids=lambda p: os.path.relpath(p, REF))
def test_native_parse_matches_python(deck):
    assert_same(native.parse(deck), inp.parse(deck))
    flat = native.parse_flat(deck)
    j_flat = j_native.parse_flat(deck)
    assert list(flat) == list(j_flat)
    for key in flat:
        assert_same(flat[key], j_flat[key], key)


def test_native_parse_generated_strip():
    text = meshgen.quad_strip_deck(20, 5)
    a, b = inp.parse(text), native.parse(text)
    assert len(a.elements) == len(b.elements) == 100
    assert_same(b, a)


def test_native_parse_trailing_tokens_per_record():
    """Legal decks may carry trailing tokens on any fixed-count record line
    (the reference's list-directed READ advances one record per line)."""
    deck = (
        "implicit 2 1 extra junk\n"
        "1 4 1 0 0 1 0 2\n"
        "1.0 0.5 10 ascii\n"
        "qua 1 2 3 4 1 0\n"
        "0.0 0.0 999\n"
        "1.0 0.0 888 777\n"
        "1.0 1.0 ! comment\n"
        "0.0 1.0 trailing\n"
        "100.0 0.3 0.0 0.0 1.0 extra-mat-token\n"
        "1 0 0 0.0 0.0 42\n"
        "2 0 1 0.0 0.0 43 44\n"
        "3 1.0 2.0 0.0 1.0 junk\n"
    )
    b = native.parse(deck)
    assert_same(b, inp.parse(deck))
    assert b.coords[1, 0] == 1.0 and b.coords[1, 1] == 0.0


def test_native_parse_error_messages():
    with pytest.raises(ValueError, match="unknown element type"):
        native.parse("implicit 2 1\n1 3 1 0 0 0 0 0\n1.0 1.0\nquux 1 2 3 1 0\n")
    with pytest.raises(ValueError, match="node id out of range"):
        native.parse("implicit 2 1\n1 3 1 0 0 0 0 0\n1.0 1.0\ntri 1 2 9 1 0\n")


@pytest.mark.parametrize("nparts", [2, 3, 8])
def test_rcb_partition_balance(nparts):
    c = np.random.default_rng(1).uniform(size=(1000, 2))
    part = native.rcb_partition(c, nparts)
    np.testing.assert_array_equal(part, j_native.rcb_partition(c, nparts))
    counts = np.bincount(part, minlength=nparts)
    assert counts.max() - counts.min() <= 1
    for p in range(nparts):
        ext = c[part == p].max(axis=0) - c[part == p].min(axis=0)
        assert ext.prod() < 0.75


def test_load_backend_dispatch(monkeypatch):
    deck = meshgen.quad_strip_deck(3, 1)
    a = problem_mod.load(deck, backend="python")
    b = problem_mod.load(deck, backend="auto")
    assert_same(b, problem_mod.load(deck, backend="native"))
    assert a.nels == b.nels
    np.testing.assert_array_equal(a.coords, b.coords)
    # "auto" takes the native engine: its Problem comes from the flat arrays
    calls = []
    flat = native.parse_flat
    monkeypatch.setattr(native, "parse_flat",
                        lambda src: calls.append(src) or flat(src))
    problem_mod.load(deck)
    assert len(calls) == 1
    # without the library "native" raises, "auto" takes the Python parser
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native mesh engine not built"):
        problem_mod.load(deck, backend="native")
    assert_same(problem_mod.load(deck), a)


def test_without_library_every_native_call_raises(monkeypatch):
    """Without the library the parser raises fem_tpu's RuntimeError;
    rcb_partition, which `--shards` calls, takes its numpy form as fem_tpu's
    does (tests/test_torch_partition.py holds it to the library)."""
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    c = np.random.default_rng(0).random((10, 3))
    for call in (lambda: native.parse_flat(DECKS[0]),
                 lambda: native.parse(DECKS[0])):
        with pytest.raises(RuntimeError, match="native mesh engine not built"):
            call()
    part = native.rcb_partition(c, 2)
    assert part.dtype == np.int32 and np.bincount(part).tolist() == [5, 5]


@pytest.mark.parametrize("deck", [DECKS[0], DECKS[1], "strip"],
                         ids=["elastic_test", "cohesive_test_2", "strip"])
def test_from_flat_matches_fem_tpu(deck):
    src = meshgen.quad_strip_deck(6, 2) if deck == "strip" else deck
    assert_same(problem_mod.Problem.from_flat(native.parse_flat(src)),
                j_problem.Problem.from_flat(j_native.parse_flat(src)))
