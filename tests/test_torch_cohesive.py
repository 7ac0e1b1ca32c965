"""The port's cohesive element math, System cohesive terms, cohesive mesh
generators and GMRES against fem_tpu, in float64 on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models import problem as j_problem
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import cohesive as j_coh
from fem_tpu.solver import gmres as j_gmres
from fem_tpu.solver import newton as j_newton
from fem_tpu_torch.io import meshgen
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import cohesive as coh
from fem_tpu_torch.solver import gmres

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DN = 0.01  # delta_n = delta_t of the inputs below


def close(got, ref, rtol):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def element_inputs(seed, opening):
    """Random cohesive elements (slanted, stretched) with interleaved
    displacements whose normal/tangential openings are ~opening * delta_n:
    below the traction peak for opening < 1, past it for opening > 1."""
    rng = np.random.default_rng(seed)
    ne = 12
    x0 = rng.uniform(-1, 1, (ne, 2))
    ang = rng.uniform(0, 2 * np.pi, ne)
    length = rng.uniform(0.2, 2.0, ne)
    t = np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]
    # bottom-left, bottom-right, top-right, top-left (duplicated nodes)
    ec = np.stack([x0, x0 + t, x0 + t, x0], 1)
    props = np.stack([rng.uniform(50, 150, ne), np.full(ne, DN),
                      np.full(ne, DN), rng.uniform(0.5, 1.0, ne),
                      rng.uniform(0.0, 0.5, ne), rng.uniform(0.0, 0.1, ne)],
                     1)
    ue = rng.normal(size=(ne, 8)) * 0.1 * DN
    ue[:, 4:] += np.tile(rng.uniform(0.5, 1.5, (ne, 2)) * opening * DN,
                         (1, 2))
    return ec, props, ue


@pytest.mark.parametrize("opening", [0.3, 2.5], ids=["pre_peak", "post_peak"])
@pytest.mark.parametrize("quirks", [False, True])
def test_cohesive_ops_match_fem_tpu(opening, quirks):
    ec, props, ue = element_inputs(0, opening)
    dt = 0.25
    t = torch.as_tensor
    for got, ref in zip(coh.geometry(t(ec)), j_coh.geometry(jnp.asarray(ec))):
        close(got, ref, rtol=1e-13)
    g = coh.gaps(t(ec), t(ue), dt)
    jg = j_coh.gaps(jnp.asarray(ec), jnp.asarray(ue), dt)
    for got, ref in zip(g, jg):
        close(got, ref, rtol=1e-13)
    gap_n, gap_t, vgap_n = g[0], g[1], g[2]
    assert float(gap_n.max()) > DN if opening > 1 else float(gap_n.max()) < DN
    pr = t(props)[:, None, :]
    jpr = jnp.asarray(props)[:, None, :]
    jgn, jgt, jvn = (jnp.asarray(x.numpy()) for x in (gap_n, gap_t, vgap_n))
    for got, ref in zip(coh.xu_needleman_traction(pr, gap_n, gap_t, vgap_n),
                        j_coh.xu_needleman_traction(jpr, jgn, jgt, jvn)):
        close(got, ref, rtol=1e-13)
    for got, ref in zip(coh.xu_needleman_stiffness(pr, gap_n, gap_t, dt),
                        j_coh.xu_needleman_stiffness(jpr, jgn, jgt, dt)):
        close(got, ref, rtol=1e-13)
    args = (t(ec), t(props), t(ue), dt, quirks)
    jargs = (jnp.asarray(ec), jnp.asarray(props), jnp.asarray(ue), dt, quirks)
    close(coh.element_force(*args), j_coh.element_force(*jargs), rtol=1e-13)
    close(coh.element_stiffness(*args), j_coh.element_stiffness(*jargs),
          rtol=1e-13)


@pytest.mark.parametrize("opening", [0.3, 2.5], ids=["pre_peak", "post_peak"])
def test_element_stiffness_is_minus_jacfwd_of_force(opening):
    ec, props, ue = (torch.as_tensor(a) for a in element_inputs(1, opening))
    ke = coh.element_stiffness(ec, props, ue, 0.5)
    ad = coh.element_stiffness_ad(ec, props, ue, 0.5)
    close(ke, ad, rtol=1e-9)
    # and the quirks tangent is not the force's derivative
    kq = coh.element_stiffness(ec, props, ue, 0.5, quirks=True)
    assert float((kq - ad).abs().max()) > 1e-3 * float(ad.abs().max())


def system_pair(jp):
    return (JSystem(jp), System(Problem.from_reference(jp), torch.float64,
                                device="cpu"))


@pytest.mark.parametrize("source", ["cohesive_test_2", "strip"])
@pytest.mark.parametrize("quirks", [False, True])
def test_system_cohesive_terms_match_fem_tpu(source, quirks):
    if source == "strip":
        jp = j_meshgen.cohesive_interface_problem(
            6, 3, open_disp=0.004, dt=0.25,
            coh_props=(100.0, DN, DN, 1.0, 0.0, 0.05))
    else:
        jp = j_problem.load(os.path.join(ROOT, "examples", "ref",
                                         "cohesive_test_2.inp"),
                            backend="python")
    js, s = system_pair(jp)
    close(s.coh["props"], js.blocks["coh"]["props"], rtol=0)
    rng = np.random.default_rng(2)
    for scale in (0.2 * DN, 3.0 * DN):  # either side of the peak
        u = rng.normal(size=s.ndof) * scale
        v = rng.normal(size=s.ndof)
        tu, ju = torch.as_tensor(u), jnp.asarray(u)
        close(s.coh_force(tu, quirks), js.coh_force(ju, quirks), rtol=1e-13)
        close(s.coh_stiffness_dense(tu, quirks),
              js.coh_stiffness_dense(ju, quirks), rtol=1e-13)
        close(s.coh_matvec(tu, torch.as_tensor(v), quirks),
              js.coh_matvec(ju, jnp.asarray(v), quirks), rtol=1e-12)
        close(s.coh_diag(tu, quirks), j_newton._coh_diag(js, ju, quirks),
              rtol=1e-13)
    # the elastic operator still leaves the cohesive elements out
    close(s.dense_K(), js.dense_K(), rtol=1e-12)


@pytest.mark.parametrize("name", ["el_test.inp", "lin_two_quads_qs.inp",
                                  "cohesive_test_2.inp"])
def test_cumulative_loads_match_fem_tpu(name):
    jp = j_problem.load(os.path.join(ROOT, "examples", "ref", name),
                        backend="python")
    js, s = system_pair(jp)
    for t_end in (0.5 * jp.dt, jp.dt, 0.4 * jp.t, jp.t):
        close(s.rhs_cumulative(t_end), js.rhs_cumulative(t_end), rtol=1e-14)
        close(s.bc_total_vals(t_end), js.bc_total_vals(t_end), rtol=1e-15)
    # the per-step windows sum to the cumulative load
    total = sum(s.rhs(jp.dt * k) for k in range(jp.nsteps))
    close(total, s.rhs_cumulative(jp.dt * jp.nsteps), rtol=1e-12)


def test_cohesive_meshgen_matches_fem_tpu():
    kw = dict(open_disp=0.015, t=1.0, dt=0.5, E=3640.0,
              coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    p = meshgen.cohesive_interface_problem(12, 5, lx=5.0, ly_half=1.0, **kw)
    jp = j_meshgen.cohesive_interface_problem(12, 5, lx=5.0, ly_half=1.0,
                                              **kw)
    assert set(p.blocks) == set(jp.blocks) == {"qua", "coh"}
    for name in p.blocks:
        for f in ("conn", "mat", "nlmat", "eids"):
            np.testing.assert_array_equal(getattr(p.blocks[name], f),
                                          getattr(jp.blocks[name], f))
    for f in ("coords", "mats", "coh_laws", "coh_props", "bc_dofs", "bc_vals",
              "force_dofs", "force_vec", "trac_dofs"):
        np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
    assert p.has_cohesive and p.ndof == jp.ndof
    for args in ((), (5, 2, 0.01, 1.0, 0.5)):
        assert (meshgen.cohesive_interface_deck(*args)
                == j_meshgen.cohesive_interface_deck(*args))


def _gmres_pair(A, b, **kw):
    At = torch.as_tensor(A)
    Aj = jnp.asarray(A)
    res = gmres.gmres(lambda v: At @ v, torch.as_tensor(b), **kw)
    jres = j_gmres.gmres(lambda v: Aj @ v, jnp.asarray(b), **kw)
    return res, jres


@pytest.mark.parametrize("kind", ["nonsymmetric", "spd"])
@pytest.mark.parametrize("restart", [8, 30])
def test_gmres_matches_fem_tpu(kind, restart):
    rng = np.random.default_rng(5)
    n = 60
    if kind == "spd":
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        A = Q @ np.diag(np.linspace(1.0, 300.0, n)) @ Q.T
    else:
        A = rng.normal(size=(n, n)) + 2.0 * np.sqrt(n) * np.eye(n)
    b = rng.normal(size=n)
    d = np.abs(np.diag(A))
    res, jres = _gmres_pair(A, b, rtol=1e-11, restart=restart, maxiter=600,
                            precond=None)
    assert res.iters == int(jres.iters) > 8  # restarts happened at 8
    close(res.x, jres.x, rtol=1e-10)
    assert res.resnorm <= 1e-11 * np.linalg.norm(b)
    close(res.x, np.linalg.solve(A, b), rtol=1e-9)
    # right-preconditioned (Jacobi), as the Newton fallback runs it
    dt_, dj = torch.as_tensor(1.0 / d), jnp.asarray(1.0 / d)
    At, Aj = torch.as_tensor(A), jnp.asarray(A)
    res = gmres.gmres(lambda v: At @ v, torch.as_tensor(b),
                      precond=lambda v: dt_ * v, rtol=1e-10, restart=restart)
    jres = j_gmres.gmres(lambda v: Aj @ v, jnp.asarray(b),
                         precond=lambda v: dj * v, rtol=1e-10,
                         restart=restart)
    assert res.iters == int(jres.iters)
    close(res.x, jres.x, rtol=1e-10)


def test_gmres_float32_breakdown_no_nan():
    """Happy breakdown in float32: A = 2I converges in ONE inner iteration
    and nothing in x turns NaN."""
    b = torch.as_tensor(np.random.default_rng(4).normal(size=16),
                        dtype=torch.float32)
    res = gmres.gmres(lambda v: 2.0 * v, b, rtol=1e-6, restart=8)
    assert bool(torch.isfinite(res.x).all())
    np.testing.assert_allclose(res.x.numpy(), b.numpy() / 2.0, rtol=1e-6)
    assert res.iters == 1


def test_gmres_counts_actual_inner_iterations():
    rng = np.random.default_rng(5)
    n = 40
    A = torch.as_tensor(rng.normal(size=(n, n)) + n * np.eye(n))
    b = torch.as_tensor(rng.normal(size=n))
    res = gmres.gmres(lambda v: A @ v, b, rtol=1e-4, restart=30)
    assert 0 < res.iters < 30
    assert res.resnorm <= 1e-4 * float(torch.linalg.norm(b))
