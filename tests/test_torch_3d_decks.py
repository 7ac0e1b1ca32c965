"""fem_tpu's 3D decks through the port: a tet element, a 3D face traction,
and traction records on a hex face and a tet face at once (the padded
traction table and its per-node weights). Each deck runs through both
packages' stepper.run on the CPU in float64."""

import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.models import problem as j_problem
from fem_tpu.models.system import System as JSystem
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.system import System
from fem_tpu_torch.solver import stepper
from test_3d_decks import HEX_DECK, MIXED_TRAC_DECK, TET_DECK

torch.set_num_threads(1)

DECKS = {"hex_face_traction": HEX_DECK, "tet_point_force": TET_DECK,
         "mixed_hex_tet_traction": MIXED_TRAC_DECK}
# Jacobi-CG iterations of each deck's one step, in both packages
JACOBI_ITERS = {"hex_face_traction": 4, "tet_point_force": 1,
                "mixed_hex_tet_traction": 18}


def same(got, ref, tol):
    """max |got - ref| <= tol * max |ref|, shapes equal."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(DECKS))
def test_3d_deck_direct_matches_fem_tpu(name):
    """The direct row: u and nodal stress to 1e-12 of the largest entry."""
    jr = j_stepper.run(j_problem.load(DECKS[name]), JConfig(solver="direct"))
    r = stepper.run(problem_mod.load(DECKS[name]),
                    Config(device="cpu", solver="direct"))
    assert r.path == "direct" and r.nsteps == jr.nsteps
    assert same(r.aggregate_u, jr.aggregate_u, 1e-12)
    assert same(r.aggregate_stress, jr.aggregate_stress, 1e-12)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_3d_deck_jacobi_cg_matches_fem_tpu(name):
    """The Jacobi-CG row: fem_tpu's iteration count, and u to 1e-8 of the
    largest entry."""
    kw = dict(solver="cg", precond="jacobi")
    jr = j_stepper.run(j_problem.load(DECKS[name]), JConfig(**kw))
    r = stepper.run(problem_mod.load(DECKS[name]), Config(device="cpu", **kw))
    assert r.path == "unstructured_jacobi_cg"
    assert r.krylov_iters == [int(i) for i in jr.krylov_iters] == [
        JACOBI_ITERS[name]]
    assert same(r.aggregate_u, jr.aggregate_u, 1e-8)


def test_mixed_traction_weights_and_rhs_match_fem_tpu():
    """The hex face (4 nodes) and the tet face (3 nodes, one padding row of
    weight 0) give fem_tpu's traction table and weights exactly, and the
    same load vector; the tet apex off the loaded face gets nothing."""
    js = JSystem(j_problem.load(MIXED_TRAC_DECK))
    s = System(problem_mod.load(MIXED_TRAC_DECK), device="cpu")
    np.testing.assert_array_equal(s.trac_node_w.numpy(),
                                  np.asarray(js.trac_node_w))
    np.testing.assert_array_equal(s.trac_node_w.numpy(),
                                  [[1, 1, 1, 1], [1, 1, 1, 0]])
    np.testing.assert_array_equal(s.trac_dofs.numpy(),
                                  np.asarray(js.trac_dofs))
    F = s.rhs(0.0).numpy()
    assert same(F, np.asarray(js.rhs(0.0)), 1e-15)
    assert not F.reshape(9, 3)[8].any()
