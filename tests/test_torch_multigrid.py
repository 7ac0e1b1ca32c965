"""fem_tpu_torch's stencil operator forms (2D, per-cell fields), detection
and geometric multigrid hierarchy against fem_tpu in float64, and the cycle
with its fine level on the slab-sharded stencil."""

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


def clamped_bc(shape):
    """The x = 0 face (the y = 0 row in 2D), every component."""
    pdim = len(shape)
    nodes = np.arange(int(np.prod(shape))).reshape(shape)
    return (nodes[0].reshape(-1)[:, None] * pdim + np.arange(pdim)).reshape(-1)


def hierarchies(shape, field=False):
    if field:
        op, jop = field_pair(shape, 4)
    else:
        op, jop = pair(shape, CELLS[:len(shape)])
    bc = clamped_bc(shape)
    h = multigrid.build(op, torch.as_tensor(bc))
    jh = j_mg.build(jop, jnp.asarray(bc), smoother="chebyshev")
    return h, jh


def assert_levels_match(h, jh):
    """Each level's grid, mask, diagonal and Chebyshev interval are
    fem_tpu's (its chebyshev smoother, degree 3, interval lambda_max / 30)."""
    assert len(h.levels) == len(jh.levels)
    assert (jh.smoother, jh.degree, jh.gamma) == ("chebyshev", 3, 1)
    for lv, jlv in zip(h.levels, jh.levels):
        assert lv.op.shape == jlv.op.shape
        np.testing.assert_array_equal(lv.maskf.numpy(), np.asarray(jlv.maskf))
        assert rel(1.0 / lv.dinv, jlv.diag) < 1e-13
        for a, b in ((lv.theta, jlv.theta), (lv.delta, jlv.delta)):
            assert abs(a - b) <= 1e-10 * max(abs(b), 1e-300)


@pytest.mark.parametrize("shape,field", [
    ((9, 9, 5), False),
    ((9, 5, 9), True),
    ((9, 17), False),
], ids=["3d", "3d_field", "2d"])
def test_multigrid_matches_fem_tpu(shape, field):
    h, jh = hierarchies(shape, field)
    assert len(h.levels) >= 2
    assert_levels_match(h, jh)
    assert rel(h.coarse_inv, jh.coarse_inv) < 1e-10
    r = np.random.default_rng(7).standard_normal(h.levels[0].op.ndof)
    assert rel(multigrid.v_cycle(h, torch.as_tensor(r)),
               j_mg.v_cycle(jh, jnp.asarray(r))) < 1e-11


@pytest.fixture(scope="module")
def fallback():
    """Hierarchies whose coarsening stops above multigrid.COARSE_MAX DOFs:
    22 cells an axis in 3D and 90 in 2D halve once to an odd count, so the
    coarsest level (12^3 x 3 = 5,184 and 46^2 x 2 = 4,232 DOFs) is solved
    by the Chebyshev polynomial in place of a dense inverse."""
    cache = {}

    def get(dim):
        if dim not in cache:
            shape = (23, 23, 23) if dim == 3 else (91, 91)
            cache[dim] = hierarchies(shape)
        return cache[dim]

    return get


def free_vectors(mask, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.where(mask, torch.zeros((), dtype=torch.float64),
                        torch.as_tensor(rng.standard_normal(mask.numel())))
            for _ in range(n)]


@pytest.mark.parametrize("dim", [3, 2], ids=["3d", "2d"])
def test_coarse_fallback_levels_match_fem_tpu(fallback, dim):
    """The two-level hierarchy is fem_tpu's, level for level; where fem_tpu
    takes 40 damped-Jacobi sweeps (omega 0.67) for the coarse solve, the
    port takes the degree-40 Chebyshev polynomial on the level's interval.
    fem_tpu's sweeps diverge above lambda_max(D^-1 A) = 2 / 0.67, which the
    3D coarse level exceeds (~3.6): its cycle is indefinite there (<v, B v>
    < 0), and positive in 2D (~2.7). The port's cycle is symmetric and
    positive in both."""
    h, jh = fallback(dim)
    assert len(h.levels) == 2 and h.coarse_inv is None
    assert h.levels[-1].op.ndof > multigrid.COARSE_MAX
    assert jh.coarse_smooth == 40 and jh.coarse_inv.size == 0
    assert_levels_match(h, jh)
    lam_max = h.levels[-1].theta + h.levels[-1].delta
    assert (lam_max > 2 / 0.67) == (dim == 3)
    v, w = free_vectors(h.levels[0].maskf > 0, 2, 11)
    bv = multigrid.v_cycle(h, v)
    assert float(v @ bv) > 0
    a, b_ = float(w @ bv), float(v @ multigrid.v_cycle(h, w))
    assert abs(a - b_) <= 1e-10 * max(abs(a), abs(b_))
    jvbv = float(v.numpy() @ np.asarray(j_mg.v_cycle(jh, jnp.asarray(
        v.numpy()))))
    assert (jvbv < 0) == (dim == 3)


@pytest.mark.parametrize("dim,most", [(3, 20), (2, 55)], ids=["3d", "2d"])
def test_coarse_fallback_preconditions_cg(fallback, dim, most):
    """As a CG preconditioner the fallback cycle reaches a true relative
    residual of 1e-10 (15 iterations in 3D, 43 in 2D), to the
    Jacobi-preconditioned CG's solution (1e-7) in a tenth of its
    iterations."""
    from fem_tpu_torch.solver import cg

    h, _ = fallback(dim)
    op = h.levels[0].op
    mask = h.levels[0].maskf > 0
    (r,) = free_vectors(mask, 1, 12)
    A = cg.masked_operator(lambda x: structured.matvec(op, x), mask)
    res = cg.pcg(A, r, rtol=1e-10, maxiter=400,
                 precond=multigrid.preconditioner(h))
    jac = cg.pcg(A, r, rtol=1e-12, maxiter=20000,
                 precond=lambda v: v * h.levels[0].dinv)
    nb = float(torch.linalg.norm(r))
    assert res.iters <= most and 10 * res.iters < jac.iters
    assert float(torch.linalg.norm(r - A(res.x))) <= 1.01e-10 * nb
    assert rel(res.x, jac.x.numpy()) < 1e-7


@pytest.mark.parametrize("shape,field", [
    ((9, 9, 5), False),
    ((9, 5, 9), True),
    ((17, 9), False),
    ((9, 17), True),
], ids=["3d", "3d_field", "2d", "2d_field"])
def test_v_cycle_applies_fine_operator_six_times(shape, field):
    """One V-cycle applies the fine level's K.u six times: two in the
    pre-smoother (its zero start needs none), one for the residual and
    three in the post-smoother. Counted through `fine_matvec`, which gives
    the level's own cycle's vector (1e-14)."""
    h, _ = hierarchies(shape, field)
    op = h.levels[0].op
    calls = []

    def counted(v):
        calls.append(v.shape)
        return structured.matvec(op, v)

    r = torch.as_tensor(np.random.default_rng(9).standard_normal(op.ndof))
    z = multigrid.v_cycle(h, r, counted)
    assert calls == [(op.ndof,)] * 6
    assert rel(z, multigrid.v_cycle(h, r).numpy()) < 1e-14


@pytest.mark.parametrize("shape", [(9, 9, 5), (9, 17)],
                         ids=["3d_chebyshev", "2d_chebyshev"])
def test_sharded_fine_level_cycle(shape):
    """The cycle with its fine level's K.u on the slab-sharded stencil
    (4 shards; 8 leading cells): the single-device cycle's vector and
    fem_tpu's v_cycle_host_sharded on the same seeded residual (1e-10).
    The fine level's products are the only collectives, one all-reduce of
    the whole grid each; the coarser levels issue none."""
    h, jh = hierarchies(shape)
    op = h.levels[0].op
    sl = structured.shard_slabs(op, make_mesh(4, device="cpu"))
    r = np.random.default_rng(7).standard_normal(op.ndof)
    r[h.levels[0].maskf.numpy() > 0] = 0.0
    tr = torch.as_tensor(r)
    out = {}
    cols = commcount.collectives(lambda: out.update(z=multigrid.v_cycle(
        h, tr, lambda v: structured.matvec_sharded(sl, v))))
    assert rel(out["z"], multigrid.v_cycle(h, tr).numpy()) < 1e-10
    assert rel(out["z"], j_mg.v_cycle_host_sharded(
        jh, jnp.asarray(r), j_make_mesh(4))) < 1e-10
    # pre-smoothing from zero (2), the residual (1), post-smoothing (3)
    ar = [c for c in cols if c[0] == "all_reduce_sum"]
    assert len(ar) == 6 and {c[2] for c in ar} == {op.ndof * 8}
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
