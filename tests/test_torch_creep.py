"""fem_tpu_torch's viscoelastic creep against fem_tpu on the CPU in float64:
the power-law creep laws, the System creep terms, and viscoelastic runs of
the linear rows (ports of tests/test_creep.py and tests/test_viscoelastic.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models import problem as j_problem
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import dmat as j_dmat
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.config import Config
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import dmat, stiffness
from fem_tpu_torch.solver import stepper

from tests.test_viscoelastic import _shear_problem

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAWS = ("creep_beta2d", "creep_betad2d", "creep_beta3d", "creep_betad3d")


def close(got, ref, rtol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("expn", [1.0, 2.0, 3.5])
@pytest.mark.parametrize("law", LAWS)
def test_creep_law_matches_fem_tpu(law, expn):
    rng = np.random.default_rng(LAWS.index(law))
    d = 3 if "2d" in law else 6
    s = rng.normal(size=(5, 4, d)) * 3.0
    visc = rng.uniform(1.0, 10.0, size=(5, 1))
    got = getattr(dmat, law)(torch.as_tensor(s), torch.as_tensor(visc), expn)
    close(got, getattr(j_dmat, law)(jnp.asarray(s), jnp.asarray(visc), expn),
          rtol=1e-13)


@pytest.mark.parametrize("expn", [1.0, 2.0, 3.5])
@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_betad_is_jacobian_of_beta(dim, expn):
    rng = np.random.default_rng(1)
    s = torch.as_tensor(rng.normal(size=3 if dim == "2d" else 6) * 3.0)
    beta = getattr(dmat, f"creep_beta{dim}")
    jac = torch.func.jacfwd(lambda x: beta(x, 7.0, expn))(s)
    close(getattr(dmat, f"creep_betad{dim}")(s, 7.0, expn), jac, rtol=1e-9)


def test_creep_deviatoric_and_zero_kappa_cases():
    # pure shear: kappa = tau, beta = tau^(n-1) / (4 visc) (0, 0, 4 tau)
    tau, visc, expn = 2.0, 10.0, 3.0
    beta = dmat.creep_beta2d(torch.tensor([0.0, 0.0, tau],
                                          dtype=torch.float64), visc, expn)
    close(beta, tau ** (expn - 1.0) / (4 * visc) * np.array([0, 0, 4 * tau]),
          rtol=1e-12)
    # equal biaxial stress: kappa = 0, no deviatoric flow
    assert not dmat.creep_beta2d(torch.tensor([5.0, 5.0, 0.0],
                                              dtype=torch.float64),
                                 1.0, 1.0).any()
    # creep flow is deviatoric: no volume change
    s = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 6)))
    assert float(dmat.creep_beta3d(s, 2.0, 2.5)[:, :3].sum(1).abs().max()) \
        < 1e-12
    # kappa == 0: beta and betad exactly zero, nothing non-finite
    for d, law in ((3, "2d"), (6, "3d")):
        z = torch.zeros(2, d, dtype=torch.float64)
        for fn in (f"creep_beta{law}", f"creep_betad{law}"):
            out = getattr(dmat, fn)(z, 1.0, 2.0)
            assert torch.isfinite(out).all() and not out.any()


def test_maxwell_shear_ramp():
    """Single quad, pure shear ramp, expn = 1: sigma_xy(t) = G gamma' tau
    (1 - exp(-t/tau)), tau = visc/G, to 3%; fem_tpu's run to 1e-12."""
    E, visc, gamma, T = 100.0, 20.0, 0.02, 2.0
    G = E / 2.0
    jp = _shear_problem(E, 0.0, visc, gamma, T, 0.01)
    cfg = dict(viscoelastic=True, solver="direct", bc_mode="eliminate")
    res = stepper.run(Problem.from_reference(jp), Config(device="cpu", **cfg))
    exact = G * (gamma / T) * (visc / G) * (1 - np.exp(-T * G / visc))
    assert abs(res.aggregate_stress[0, 2] - exact) < 0.03 * abs(exact)
    np.testing.assert_allclose(res.aggregate_u.reshape(4, 2)[2, 0], gamma,
                               atol=1e-10)
    jr = j_stepper.run(jp, JConfig(**cfg))
    close(res.aggregate_stress, jr.aggregate_stress, rtol=1e-12)
    close(res.aggregate_u, jr.aggregate_u, rtol=1e-12)


def test_without_flag_stays_elastic():
    p = Problem.from_reference(_shear_problem(100.0, 0.0, 20.0, 0.02, 2.0,
                                              0.5))
    res = stepper.run(p, Config(device="cpu"))
    np.testing.assert_allclose(res.aggregate_stress[0, 2], 50.0 * 0.02,
                               rtol=1e-8)


def test_zero_viscosity_materials_noop():
    # visc column 0: empty creep state, the very elastic run
    p = Problem.from_reference(_shear_problem(100.0, 0.0, 0.0, 0.02, 1.0,
                                              0.5))
    a = stepper.run(p, Config(device="cpu", viscoelastic=True))
    b = stepper.run(p, Config(device="cpu"))
    assert System(p, device="cpu").creep_state_init() == {}
    np.testing.assert_array_equal(a.aggregate_u, b.aggregate_u)
    np.testing.assert_array_equal(a.aggregate_stress, b.aggregate_stress)


def creeping(jp, expn, sigma, tau_steps=5.0):
    """jp with creep in every material: exponent expn and a viscosity that
    makes the relaxation time about tau_steps steps at stresses sigma."""
    jp.mats = np.array(jp.mats, dtype=float)
    E, nu = jp.mats[0, 0], jp.mats[0, 1]
    jp.mats[:, 2] = tau_steps * jp.dt * E / (2 * (1 + nu)) * sigma ** (
        expn - 1.0)
    jp.mats[:, 3] = expn
    return jp


@pytest.mark.parametrize("name", ["hex_box", "quad_grid"])
def test_system_creep_terms_match_fem_tpu(name):
    jp = (j_meshgen.hex_box_problem(3, 2, 2, jitter=0.2) if name == "hex_box"
          else j_meshgen.quad_grid_problem(4, 3))
    jp = creeping(jp, expn=2.0, sigma=1e-3 * jp.mats[0, 0])
    js = JSystem(jp)
    s = System(Problem.from_reference(jp), torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    state = {k: torch.as_tensor(rng.normal(size=v.shape) * 1e-3
                                * jp.mats[0, 0])
             for k, v in s.creep_state_init().items()}
    j_state = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    assert list(state) == list(js.creep_state_init())
    du = rng.normal(size=s.ndof) * 1e-3
    moduli = s.creep_moduli(state)
    close(s.creep_force(state, moduli), js.creep_force(j_state), rtol=1e-12)
    new = s.creep_stress_update(state, torch.as_tensor(du), moduli)
    j_new = js.creep_stress_update(j_state, jnp.asarray(du))
    for k in new:
        close(new[k], j_new[k], rtol=1e-12)
    close(s.nodal_average_state(state), js.nodal_average_state(j_state),
          rtol=1e-12)
    # the dNx contraction equals the B-matrix form sum_ip B^T g w detJ
    block = "hex" if name == "hex_box" else "qua"
    dNx, wdetj = s._creep_geometry(block)
    D_eff, beta = moduli[block]
    g = torch.einsum("eicd,eid->eic", D_eff, s.dt * beta)
    fe = torch.einsum("eica,eic,ei->ea", stiffness.bmat(dNx, s.pdim), g, wdetj)
    ref = torch.zeros(s.ndof, dtype=torch.float64).index_add_(
        0, s.blocks[block]["edofs"].reshape(-1), fe.reshape(-1))
    close(s.creep_force(state, moduli), ref, rtol=1e-13)


@pytest.mark.parametrize("row,solver,jitter", [
    ("direct", "direct", 0.0),
    ("structured_mg_cg", "cg", 0.0),
    ("unstructured_jacobi_cg", "cg", 0.2),
])
def test_viscoelastic_run_matches_fem_tpu(row, solver, jitter):
    jp = creeping(j_meshgen.hex_box_problem(
        6, 4, 4, lx=1.5, ly=1.0, lz=1.0, t=3.0, dt=1.0, jitter=jitter),
        expn=3.0, sigma=5e6)
    cfg = dict(viscoelastic=True, solver=solver)
    jr = j_stepper.run(jp, JConfig(**cfg))
    r = stepper.run(Problem.from_reference(jp), Config(device="cpu", **cfg))
    assert r.path == row and r.nsteps == 3
    close(r.aggregate_u, jr.aggregate_u, rtol=1e-9)
    close(r.aggregate_stress, jr.aggregate_stress, rtol=1e-9)
    if row == "structured_mg_cg":
        # fem_tpu's small-deck branch starts every step cold; the port
        # warm-starts, as fem_tpu's big branches do (test_torch_warmstart)
        assert r.krylov_iters[0] == jr.krylov_iters[0]
        assert all(a < b for a, b in zip(r.krylov_iters[1:],
                                         jr.krylov_iters[1:]))
    elif solver == "cg":
        assert r.krylov_iters == jr.krylov_iters
    # creep moved the run away from the elastic one
    el = stepper.run(Problem.from_reference(jp), Config(device="cpu",
                                                        solver=solver))
    assert np.abs(r.aggregate_u - el.aggregate_u).max() > 1e-3 * np.abs(
        el.aggregate_u).max()


def test_viscoelastic_cohesive_raises_like_fem_tpu():
    path = os.path.join(ROOT, "examples", "ref", "cohesive_test_2.inp")
    with pytest.raises(NotImplementedError) as j_err:
        j_stepper.run(j_problem.load(path), JConfig(viscoelastic=True))
    with pytest.raises(NotImplementedError) as err:
        stepper.run(problem_mod.load(path),
                    Config(device="cpu", viscoelastic=True))
    assert str(err.value) == str(j_err.value)
