"""fem_tpu_torch's checkpoint / resume (port of tests/test_checkpoint.py),
and checkpoints that cross between fem_tpu and the port: an interrupted run
of either package resumes in the other to the uninterrupted result."""

import os

import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.solver import stepper as j_stepper
from fem_tpu.utils import checkpoint as j_checkpoint
from fem_tpu_torch.config import Config
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.solver import stepper
from fem_tpu_torch.utils import checkpoint

from tests.test_viscoelastic import _shear_problem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELASTIC_DECK = os.path.join(ROOT, "examples", "ref", "SNES_test", "elastic",
                            "elastic_test.inp")
VISCO = dict(viscoelastic=True, solver="direct", bc_mode="eliminate")


def keep_steps_up_to(ckdir, last):
    """Delete the checkpoints after step `last`: an interruption there."""
    for name in os.listdir(ckdir):
        if int(name.split("_")[1].split(".")[0]) > last:
            os.unlink(os.path.join(ckdir, name))


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    u, du = rng.normal(size=12), rng.normal(size=12)
    s = rng.normal(size=(6, 3))
    creep = {"qua": rng.normal(size=(2, 4, 3))}
    path = checkpoint.save(str(tmp_path), 7, torch.as_tensor(u), s,
                           torch.as_tensor(du), creep_state={
                               "qua": torch.as_tensor(creep["qua"])})
    step, u2, s2, du2, creep2 = checkpoint.load(path)
    assert step == 7
    for a, b in ((u, u2), (s, s2), (du, du2), (creep["qua"], creep2["qua"])):
        np.testing.assert_array_equal(a, b)
    # on a device, in a dtype: tensors
    _, u3, _, _, creep3 = checkpoint.load(path, device="cpu",
                                          dtype=torch.float32)
    assert u3.dtype == torch.float32 and creep3["qua"].dtype == torch.float32
    # fem_tpu reads the same file, key for key
    j = j_checkpoint.load(path)
    assert j[0] == 7 and list(j[4]) == ["qua"]
    np.testing.assert_array_equal(j[1], u)
    assert checkpoint.latest(str(tmp_path)) == path
    checkpoint.save(str(tmp_path), 9, u, s, du)
    assert checkpoint.latest(str(tmp_path)).endswith("state_000009.npz")
    assert checkpoint.load(checkpoint.latest(str(tmp_path)))[4] == {}
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_latest_empty(tmp_path):
    assert checkpoint.latest(str(tmp_path)) is None
    assert checkpoint.latest(str(tmp_path / "missing")) is None


def test_resume_matches_uninterrupted(tmp_path):
    problem = problem_mod.load(ELASTIC_DECK)
    ref = stepper.run(problem, Config(device="cpu"))
    ckdir = str(tmp_path / "ck")
    full = stepper.run(problem, Config(device="cpu", checkpoint_dir=ckdir))
    np.testing.assert_array_equal(full.aggregate_u, ref.aggregate_u)
    assert len(os.listdir(ckdir)) == ref.nsteps
    keep_steps_up_to(ckdir, 4)
    msgs = []
    resumed = stepper.run(problem, Config(device="cpu", checkpoint_dir=ckdir),
                          log=msgs.append)
    assert any("Resumed from" in m and "next interval 5" in m for m in msgs)
    np.testing.assert_array_equal(resumed.aggregate_u, ref.aggregate_u)
    np.testing.assert_array_equal(resumed.aggregate_stress,
                                  ref.aggregate_stress)
    assert resumed.nsteps == ref.nsteps


def test_viscoelastic_resume_preserves_creep_state(tmp_path):
    p = Problem.from_reference(_shear_problem(100.0, 0.0, 20.0, 0.02, 1.0,
                                              0.05))
    ref = stepper.run(p, Config(device="cpu", **VISCO))
    ckdir = str(tmp_path / "ck")
    stepper.run(p, Config(device="cpu", checkpoint_dir=ckdir, **VISCO))
    with np.load(checkpoint.latest(ckdir)) as z:
        assert "creep__qua" in z.files
    keep_steps_up_to(ckdir, 10)
    resumed = stepper.run(p, Config(device="cpu", checkpoint_dir=ckdir,
                                    **VISCO))
    np.testing.assert_array_equal(resumed.aggregate_stress,
                                  ref.aggregate_stress)
    np.testing.assert_array_equal(resumed.aggregate_u, ref.aggregate_u)


def test_viscoelastic_resume_refuses_stale_checkpoint(tmp_path):
    p = Problem.from_reference(_shear_problem(100.0, 0.0, 20.0, 0.02, 1.0,
                                              0.05))
    ckdir = str(tmp_path / "ck")
    checkpoint.save(ckdir, 3, np.zeros(p.ndof), np.zeros((p.nnds, 3)),
                    np.zeros(p.ndof))
    with pytest.raises(ValueError, match="creep state"):
        stepper.run(p, Config(device="cpu", checkpoint_dir=ckdir, **VISCO))


def test_no_resume_flag(tmp_path):
    problem = problem_mod.load(ELASTIC_DECK)
    ckdir = str(tmp_path / "ck")
    stepper.run(problem, Config(device="cpu", checkpoint_dir=ckdir,
                                checkpoint_every=3))
    assert sorted(os.listdir(ckdir)) == [f"state_{k:06d}.npz"
                                         for k in (3, 6, 9)]
    ref = stepper.run(problem, Config(device="cpu"))
    msgs = []
    again = stepper.run(problem, Config(device="cpu", checkpoint_dir=ckdir,
                                        resume=False), log=msgs.append)
    assert not any("Resumed" in m for m in msgs)
    np.testing.assert_array_equal(again.aggregate_u, ref.aggregate_u)


@pytest.mark.parametrize("writer", ["fem_tpu", "fem_tpu_torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """One package writes the checkpoints of a 3-step viscoelastic run, the
    last is deleted, and the other resumes from step 2 to fem_tpu's
    uninterrupted result (to 1e-12)."""
    jp = _shear_problem(100.0, 0.3, 20.0, 0.02, 0.15, 0.05)
    p = Problem.from_reference(jp)
    ref = j_stepper.run(jp, JConfig(**VISCO))
    ckdir = str(tmp_path / "ck")
    if writer == "fem_tpu":
        j_stepper.run(jp, JConfig(checkpoint_dir=ckdir, **VISCO))
    else:
        stepper.run(p, Config(device="cpu", checkpoint_dir=ckdir, **VISCO))
    keep_steps_up_to(ckdir, 2)
    cfg = dict(checkpoint_dir=ckdir, **VISCO)
    msgs = []
    if writer == "fem_tpu":
        got = stepper.run(p, Config(device="cpu", **cfg), log=msgs.append)
    else:
        got = j_stepper.run(jp, JConfig(**cfg), log=msgs.append)
    assert any("next interval 3" in m for m in msgs)
    for a, b in ((got.aggregate_u, ref.aggregate_u),
                 (got.aggregate_stress, ref.aggregate_stress),
                 (got.du, ref.du)):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    assert checkpoint.latest(ckdir).endswith("state_000003.npz")
