"""fem_tpu_torch's stencil operator forms (2D, per-cell fields), detection
and geometric multigrid hierarchy against fem_tpu in float64, and the cycle
with its fine level on the slab-sharded stencil."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu.parallel import make_mesh as j_make_mesh
from fem_tpu.solver import multigrid as j_mg
from fem_tpu_torch.ops import structured
from fem_tpu_torch.ops.stiffness import lame
from fem_tpu_torch.parallel import commcount
from fem_tpu_torch.parallel.mesh import make_mesh
from fem_tpu_torch.solver import multigrid

torch.set_num_threads(1)

LAM, MU = j_lame(200e9, 0.3)
CELLS = (0.1, 0.2, 0.15)


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pair(shape, cells=CELLS, lam=LAM, mu=MU, dtype=np.float64):
    """The same operator from both packages."""
    jop = j_structured.build(cells, shape, jnp.asarray(lam, dtype),
                             jnp.asarray(mu, dtype), dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    op = structured.build(cells, shape, torch.as_tensor(np.asarray(lam), dtype=tdt),
                          torch.as_tensor(np.asarray(mu), dtype=tdt),
                          dtype=tdt, device="cpu")
    return op, jop


def field_pair(shape, seed):
    rng = np.random.default_rng(seed)
    cells = tuple(n - 1 for n in shape)
    lam = LAM * rng.uniform(0.5, 1.5, cells)
    mu = MU * rng.uniform(0.5, 1.5, cells)
    return pair(shape, CELLS[:len(shape)], lam, mu)


@pytest.mark.parametrize("kind", ["2d_scalar", "3d_field", "2d_field"])
def test_matvec_and_diag_other_forms(kind):
    if kind == "2d_scalar":
        op, jop = pair((7, 5), (0.3, 0.2))
    else:
        op, jop = field_pair((7, 5, 4) if kind == "3d_field" else (7, 5), 2)
    u = np.random.default_rng(3).standard_normal(jop.ndof)
    assert rel(structured.matvec(op, torch.as_tensor(u)),
               j_structured.matvec(jop, jnp.asarray(u))) < 1e-12
    g = torch.as_tensor(u).reshape(*op.shape, op.pdim)
    assert rel(structured.matvec_g(op, g).reshape(-1),
               j_structured.matvec(jop, jnp.asarray(u))) < 1e-12
    assert rel(structured.diag(op), j_structured.diag(jop)) < 1e-13


def test_detect_matches_fem_tpu():
    from fem_tpu.io import inp as j_inp
    from fem_tpu.models.problem import Problem as JProblem
    from fem_tpu_torch.models.problem import Problem

    cases = [
        j_meshgen.hex_box_problem(4, 3, 2),
        j_meshgen.hex_box_problem(3, 3, 3, jitter=0.3),
        j_meshgen.quad_grid_problem(5, 2),
        JProblem.from_deck(j_inp.parse(j_meshgen.quad_strip_deck(6, 2))),
        JProblem.from_deck(j_inp.parse(
            "examples/ref/SNES_test/elastic/elastic_test.inp")),
    ]
    got = [structured.detect(Problem.from_reference(p)) for p in cases]
    assert got == [j_structured.detect(p) for p in cases]
    assert got[0] is not None and got[1] is None and got[2] is not None


def hierarchies(shape, smoother, field=False):
    if field:
        op, jop = field_pair(shape, 4)
    else:
        op, jop = pair(shape, CELLS[:len(shape)])
    pdim = len(shape)
    nodes = np.arange(int(np.prod(shape))).reshape(shape)
    clamped = nodes[0].reshape(-1)  # x = 0 face (y = 0 row in 2D)
    bc = (clamped[:, None] * pdim + np.arange(pdim)).reshape(-1)
    h = multigrid.build(op, torch.as_tensor(bc), smoother=smoother)
    jh = j_mg.build(jop, jnp.asarray(bc), smoother=smoother)
    return h, jh


@pytest.mark.parametrize("shape,smoother,field", [
    ((9, 9, 5), "chebyshev", False),
    ((9, 5, 9), "jacobi", True),
    ((9, 17), "chebyshev", False),
])
def test_multigrid_matches_fem_tpu(shape, smoother, field):
    h, jh = hierarchies(shape, smoother, field)
    assert len(h.levels) == len(jh.levels) >= 2
    for lv, jlv in zip(h.levels, jh.levels):
        assert lv.op.shape == jlv.op.shape
        np.testing.assert_array_equal(lv.maskf.numpy(), np.asarray(jlv.maskf))
        assert rel(lv.diag, jlv.diag) < 1e-13
        for a, b in ((lv.theta, jlv.theta), (lv.delta, jlv.delta)):
            assert abs(a - b) <= 1e-10 * max(abs(b), 1e-300)
    assert rel(h.coarse_inv, jh.coarse_inv) < 1e-10
    r = np.random.default_rng(7).standard_normal(h.levels[0].op.ndof)
    assert rel(multigrid.v_cycle(h, torch.as_tensor(r)),
               j_mg.v_cycle(jh, jnp.asarray(r))) < 1e-11


def test_mg_wcycle_matches_fem_tpu_and_converges_no_slower():
    """gamma=2 (the W-cycle: a residual-corrected second coarse visit at
    every level but the last two) gives fem_tpu's preconditioned vector on
    the same seeded residual, stays symmetric, and as a CG preconditioner
    needs no more iterations than the V-cycle, to the same solution."""
    from fem_tpu_torch.solver import cg

    shape = (17, 17, 17)
    op, jop = pair(shape)
    nodes = np.arange(int(np.prod(shape))).reshape(shape)
    bc = (nodes[0].reshape(-1)[:, None] * 3 + np.arange(3)).reshape(-1)
    kw = dict(smoother="chebyshev", degree=3)
    v = multigrid.build(op, torch.as_tensor(bc), **kw)
    w = multigrid.build(op, torch.as_tensor(bc), gamma=2, **kw)
    jw = j_mg.build(jop, jnp.asarray(bc), gamma=2, **kw)
    assert (v.gamma, w.gamma) == (1, 2) and len(w.levels) == 4
    rng = np.random.default_rng(0)
    # zero on the clamped dofs, where the cycle is the identity and the
    # entries would be 1e10 times the free ones
    r = rng.standard_normal(op.ndof)
    r[bc] = 0.0
    zw = multigrid.v_cycle(w, torch.as_tensor(r))
    assert rel(zw, j_mg.v_cycle(jw, jnp.asarray(r))) < 1e-10
    # the second visit changes the cycle
    assert rel(zw, multigrid.v_cycle(v, torch.as_tensor(r)).numpy()) > 1e-3
    # symmetric: <s, B r> = <B s, r>
    s_ = rng.standard_normal(op.ndof)
    s_[bc] = 0.0
    s_ = torch.as_tensor(s_)
    a = float(torch.dot(s_, zw))
    b_ = float(torch.dot(multigrid.v_cycle(w, s_), torch.as_tensor(r)))
    assert abs(a - b_) <= 1e-10 * max(abs(a), abs(b_))
    # CG around both cycles on the clamped box under a seeded load
    mask = torch.zeros(op.ndof, dtype=torch.bool)
    mask[torch.as_tensor(bc)] = True
    A = cg.masked_operator(lambda x: structured.matvec(op, x), mask)
    rhs = torch.where(mask, torch.zeros(()).double(),
                      torch.as_tensor(rng.standard_normal(op.ndof)))
    res = [cg.pcg(A, rhs, rtol=1e-9, maxiter=200,
                  precond=multigrid.preconditioner(h)) for h in (v, w)]
    nb = float(torch.linalg.norm(rhs))
    for x in res:
        assert x.resnorm <= 1e-9 * nb * 1.01
    assert res[1].iters <= res[0].iters
    assert rel(res[1].x, res[0].x.numpy()) <= 1e-8


@pytest.mark.parametrize("shape,smoother,gamma", [
    ((9, 9, 5), "chebyshev", 1),
    ((9, 17), "jacobi", 1),
    ((17, 9, 9), "chebyshev", 2),
], ids=["3d_chebyshev", "2d_jacobi", "3d_wcycle"])
def test_sharded_fine_level_cycle(shape, smoother, gamma):
    """The cycle with its fine level's K.u on the slab-sharded stencil
    (4 shards; 8 and 16 leading cells): the single-device cycle's vector
    and fem_tpu's v_cycle_host_sharded on the same seeded residual (1e-10;
    fem_tpu has no sharded W-cycle, so gamma 2 is held to the port's own).
    The fine level's products are the only collectives, one all-reduce of
    the whole grid each; the coarser levels issue none."""
    h, jh = hierarchies(shape, smoother)
    if gamma == 2:
        h = dataclasses.replace(h, gamma=2)
        assert len(h.levels) >= 3
    op = h.levels[0].op
    sl = structured.shard_slabs(op, make_mesh(4, device="cpu"))
    r = np.random.default_rng(7).standard_normal(op.ndof)
    r[h.levels[0].maskf.numpy() > 0] = 0.0
    tr = torch.as_tensor(r)
    out = {}
    cols = commcount.collectives(lambda: out.update(z=multigrid.v_cycle(
        h, tr, lambda v: structured.matvec_sharded(sl, v))))
    assert rel(out["z"], multigrid.v_cycle(h, tr).numpy()) < 1e-10
    if gamma == 1:
        assert rel(out["z"], j_mg.v_cycle_host_sharded(
            jh, jnp.asarray(r), j_make_mesh(4))) < 1e-10
    # pre-smoothing, the residual and post-smoothing: Chebyshev(3) applies
    # K three times a half-cycle, V(2, 2) Jacobi twice
    n_fine = 7 if smoother == "chebyshev" else 5
    ar = [c for c in cols if c[0] == "all_reduce_sum"]
    assert len(ar) == n_fine and {c[2] for c in ar} == {op.ndof * 8}
    assert multigrid.preconditioner(h, lambda v: structured.matvec_sharded(
        sl, v))(tr).equal(out["z"])


def test_transfers_match_fem_tpu():
    rng = np.random.default_rng(8)
    xc = rng.standard_normal((3, 5, 4, 3))
    rf = rng.standard_normal((5, 9, 7, 3))
    assert rel(multigrid.prolong_g(torch.as_tensor(xc), 3),
               j_mg.prolong_g(jnp.asarray(xc), None, 3)) < 1e-15
    assert rel(multigrid.restrict_g(torch.as_tensor(rf), 3),
               j_mg.restrict_g(jnp.asarray(rf), None, 3)) < 1e-15


def test_lame_scalars():
    lam, mu = lame(torch.tensor(200e9, dtype=torch.float64),
                   torch.tensor(0.3, dtype=torch.float64))
    assert float(lam) == float(LAM) and float(mu) == float(MU)
