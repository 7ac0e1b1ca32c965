"""The backward kernels of the port against jax.grad of fem_tpu, in float64
at small seeded sizes: K1's gradient in the element coordinates (the plain
form of hex8_stiffness_coord_grad, and _Hex8Stiffness's backward with its
launches replaced by the plain forms), K3's gradient in x and data
(_CsrMatvec, the tables' kept transposes), and the gradient of a whole
SA-AMG V-cycle in its right-hand side. The kernels run only on a card: the
tests marked `cuda` hold them against the same plain forms there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.models.system import System as JSystem
from fem_tpu.ops import elements as j_elements
from fem_tpu.ops import operator as j_op
from fem_tpu.ops import stiffness as j_stiffness
from fem_tpu.solver import amg as j_amg
from fem_tpu.solver import cg as j_cg
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import System
from fem_tpu_torch.ops import cuda_kernels, elements, operator, stiffness
from fem_tpu_torch.solver import amg, cg

torch.set_num_threads(1)

BASE = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                 [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)


def rel_max(got, ref):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else ref
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_by_part(got, ref, mask):
    """rel_max over the free DOFs and over the constrained ones, apart: a
    masked operator's identity rows give the constrained entries of a
    V-cycle's gradient O(1), the free ones O(1 / (E h)), so one maximum over
    all would not see the free entries, the only ones the transfers reach."""
    got, ref = (np.asarray(a.detach().cpu() if torch.is_tensor(a) else a)
                for a in (got, ref))
    mask = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask)
    return max(rel_max(got[~mask], ref[~mask]), rel_max(got[mask], ref[mask]))


def hex_batch(ne, seed, per_element, device="cpu", dtype=torch.float64):
    """A jittered batch of ne hex8 as (ne, 8, 3) numpy coordinates, (ne,)
    lam and mu (one pair for all, or one per element) and a (24, 24, ne)
    output gradient W; and the same as K1's (3, 8, ne) tensors."""
    rng = np.random.default_rng(seed)
    x = BASE[None] + 0.1 * rng.normal(size=(ne, 8, 3))
    if per_element:
        lam, mu = rng.uniform(1, 2, ne), rng.uniform(1, 2, ne)
    else:
        lam, mu = np.full(ne, 1.7), np.full(ne, 1.1)
    W = rng.normal(size=(24, 24, ne))
    tensors = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
               for a in (np.transpose(x, (2, 1, 0)), lam, mu, W)]
    return (x, lam, mu, W), tensors


@pytest.mark.parametrize("per_element", [False, True])
def test_k1_coord_grad_plain_matches_jax(per_element):
    """(a) d<W, k_e>/dx of fem_tpu's element_stiffness_lame under jax.grad."""
    (x, lam, mu, W), (xl, lam_t, mu_t, W_t) = hex_batch(16, 11, per_element)
    got = cuda_kernels.hex8_stiffness_coord_grad_plain(xl, lam_t, mu_t, W_t)
    j_et = j_elements.get("hex")
    ref = jax.grad(lambda xx: jnp.sum(
        np.transpose(W, (2, 0, 1))
        * j_stiffness.element_stiffness_lame(j_et, xx, lam, mu)))(
        jnp.asarray(x))
    assert rel_max(got, np.transpose(np.asarray(ref), (2, 1, 0))) <= 1e-12


@pytest.mark.parametrize("per_element", [False, True])
def test_k1_coord_grad_plain_matches_autograd(per_element):
    """(b) the same against torch autograd of K1's plain form."""
    _, (xl, lam, mu, W) = hex_batch(16, 12, per_element)
    xg = xl.clone().requires_grad_()
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(xg, lam, mu)).sum(), xg)
    got = cuda_kernels.hex8_stiffness_coord_grad_plain(xl, lam, mu, W)
    assert rel_max(got, ref) <= 1e-12
    # only W's symmetric part counts: k_e is symmetric
    got_t = cuda_kernels.hex8_stiffness_coord_grad_plain(
        xl, lam, mu, W.transpose(0, 1).contiguous())
    assert rel_max(got_t, ref) <= 1e-12


@pytest.fixture
def plain_k1_launches(monkeypatch):
    """K1's two launches replaced by their plain forms; the calls of each
    are counted."""
    calls = {"hex8_stiffness": 0, "hex8_stiffness_coord_grad": 0}

    def k1(*a):
        calls["hex8_stiffness"] += 1
        return cuda_kernels.hex8_stiffness_plain(*a)

    def coord_grad(*a):
        calls["hex8_stiffness_coord_grad"] += 1
        return cuda_kernels.hex8_stiffness_coord_grad_plain(*a)

    monkeypatch.setattr(cuda_kernels, "_hex8_launch", k1)
    monkeypatch.setattr(cuda_kernels, "_hex8_coord_grad_launch", coord_grad)
    return calls


@pytest.mark.parametrize("wrt,k1,coord", [
    ("x", 1, 1),  # the forward, then one coordinate-gradient launch
    ("x lam mu", 3, 1),  # and two more K1 launches for (lam, mu)
])
def test_k1_autograd_function_coord_grad(plain_k1_launches, wrt, k1, coord):
    """(c) _Hex8Stiffness's backward gives the coordinate gradient of the
    plain form's autograd with the stated launches."""
    _, (x, lam, mu, W) = hex_batch(9, 13, True)
    args = dict(x=x, lam=lam, mu=mu)
    inputs = [args[k].requires_grad_() for k in wrt.split()]
    got = torch.autograd.grad(
        (W * cuda_kernels._Hex8Stiffness.apply(x, lam, mu)).sum(), inputs)
    assert plain_k1_launches == {"hex8_stiffness": k1,
                                 "hex8_stiffness_coord_grad": coord}
    ref = torch.autograd.grad(
        (W * cuda_kernels.hex8_stiffness_plain(x, lam, mu)).sum(), inputs)
    for g, r in zip(got, ref):
        assert rel_max(g, r) <= 1e-12


def uneven_table(seed, n=300, ncols=257):
    """A CSR table with empty rows and rows of very different lengths (0 to
    200 nonzeros, a Pareto spread), and its scipy matrix."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum((rng.pareto(1.0, n) * 2).astype(int), 200)
    rows = np.repeat(np.arange(n), lengths)
    A = sp.csr_matrix((rng.normal(size=rows.size),
                       (rows, rng.integers(0, ncols, rows.size))),
                      shape=(n, ncols))
    assert (np.diff(A.indptr) == 0).any() and np.diff(A.indptr).max() >= 50
    return amg.Csr.from_csr(A, torch.float64, "cpu"), A, rng


@pytest.fixture
def plain_k3_launches(monkeypatch):
    """K3's launches replaced by their plain forms, the wrapper routing CPU
    tensors through _CsrMatvec as it routes CUDA ones; counts the calls of
    each launch and each forming of a transpose."""
    calls = {"csr_matvec": 0, "csr_data_grad": 0, "csr_transpose": 0}
    real_transpose = cuda_kernels.csr_transpose

    def k3(indptr, indices, data, x, lanes):
        calls["csr_matvec"] += 1
        return cuda_kernels.csr_matvec_plain(indptr, indices, data, x)

    def data_grad(indptr, indices, x, gy, lanes):
        calls["csr_data_grad"] += 1
        return cuda_kernels.csr_data_grad_plain(indptr, indices, x, gy)

    def forming(*a):
        calls["csr_transpose"] += 1
        return real_transpose(*a)

    def wrapper(indptr, indices, data, x, lanes, transpose):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or data.requires_grad):
            return cuda_kernels._CsrMatvec.apply(indptr, indices, data, x,
                                                 lanes, transpose)
        return k3(indptr, indices, data, x, lanes)

    monkeypatch.setattr(cuda_kernels, "_k3_launch", k3)
    monkeypatch.setattr(cuda_kernels, "_csr_data_grad_launch", data_grad)
    monkeypatch.setattr(cuda_kernels, "csr_transpose", forming)
    monkeypatch.setattr(cuda_kernels, "csr_matvec", wrapper)
    return calls


@pytest.mark.parametrize("wrt", ["x", "data", "x data"])
def test_k3_autograd_function(plain_k3_launches, wrt):
    """(d) _CsrMatvec's gradients in x and data equal csr_matvec_plain's
    autograd on an uneven table; x's backward is one K3 launch on the
    transposed table, formed once and kept by the table."""
    t, A, rng = uneven_table(21)
    x = torch.as_tensor(rng.normal(size=A.shape[1]))
    gy = torch.as_tensor(rng.normal(size=A.shape[0]))
    data = t.data.clone()
    t = dataclasses.replace(t, data=data)
    args = dict(x=x, data=data)
    inputs = [args[k].requires_grad_() for k in wrt.split()]
    for rep in range(2):
        got = torch.autograd.grad(t(x), inputs, gy)
        ref = torch.autograd.grad(cuda_kernels.csr_matvec_plain(
            t.indptr, t.indices, data, x), inputs, gy)
        for g, r in zip(got, ref):
            assert rel_max(g, r) <= 1e-14
    assert plain_k3_launches == {
        "csr_matvec": 2 * (1 + ("x" in wrt.split())),
        "csr_data_grad": 2 * ("data" in wrt),
        "csr_transpose": int("x" in wrt.split())}
    if "x" in wrt.split():
        assert rel_max(got[0], A.T @ gy.numpy()) <= 1e-14


def test_k3_transpose_is_kept():
    """Csr.transposed forms A^T once and keeps it; a copy made with
    dataclasses.replace keeps none and forms its own."""
    t, A, _ = uneven_table(23)
    tt = t.transposed()
    assert tt is t.transposed() and tt.shape == (A.shape[1], A.shape[0])
    assert (tt.to_scipy() != A.T.tocsr()).nnz == 0
    assert tt.lanes == cuda_kernels.csr_lanes(A.shape[1], A.nnz)
    copy = dataclasses.replace(t, data=2.0 * t.data)
    assert copy._t is None
    assert (copy.transposed().to_scipy() != 2.0 * A.T.tocsr()).nnz == 0


def masked_fused(jp, device):
    """The port's masked fused operator of fem_tpu problem jp on device, and
    its mask of constrained DOFs."""
    s = System(Problem.from_reference(jp), torch.float64, device=device)
    mask = torch.zeros(s.ndof, dtype=torch.bool, device=device)
    mask[s.bc_dofs] = True
    fop = operator.build(s)
    return cg.masked_operator(lambda v: operator.matvec(fop, v), mask), mask


@pytest.fixture(scope="module")
def box6():
    """The jittered 6^3 box (1,029 DOFs): fem_tpu's SA hierarchy with its
    mid levels as ELL tables, to be carried into the port, both packages'
    masked fused operators, the port's mask of constrained DOFs, and the
    problem."""
    jp = j_meshgen.hex_box_problem(6, 6, 6, jitter=0.25)
    js = JSystem(jp, dtype=jnp.float64)
    jh = j_amg.build(js, js.bc_dofs, coarse_max=40, dense_level_max=0,
                     A=j_amg.assemble_csr(js))
    assert len(jh.levels) >= 3  # a CSR mid level exists
    jmask = jnp.zeros(js.ndof, bool).at[js.bc_dofs].set(True)
    jfop = j_op.build(js)
    jA = j_cg.masked_operator(lambda v: j_op.matvec(jfop, v), jmask)
    A, mask = masked_fused(jp, "cpu")
    return jh, jA, A, mask, jp


def test_from_reference_links_p_and_r(box6):
    h = amg.from_reference(box6[0])
    for lv in h.levels[:-1]:
        assert lv.P.transposed() is lv.R and lv.R.transposed() is lv.P


def v_cycle_grad(h, A, r, w):
    rt = torch.as_tensor(r).requires_grad_()
    (g,) = torch.autograd.grad((torch.as_tensor(w)
                                * amg.v_cycle(h, A, rt)).sum(), rt)
    return g


def test_v_cycle_gradient_matches_jax(box6):
    """(e) d<w, v_cycle(r)>/dr on fem_tpu's hierarchy carried into the port
    against jax.grad of fem_tpu's cycle; the cycle is symmetric, so it is
    also the cycle applied to w."""
    jh, jA, A, mask, _ = box6
    rng = np.random.default_rng(31)
    r, w = rng.normal(size=mask.shape[0]), rng.normal(size=mask.shape[0])
    h = amg.from_reference(jh)
    got = v_cycle_grad(h, A, r, w)
    ref = jax.grad(lambda rr: jnp.sum(w * j_amg.v_cycle(jh, jA, rr)))(
        jnp.asarray(r))
    assert rel_by_part(got, ref, mask) <= 1e-10
    with torch.no_grad():
        sym = amg.v_cycle(h, A, torch.as_tensor(w))
    assert rel_by_part(got, sym, mask) <= 1e-10


def test_v_cycle_gradient_through_k3_function(box6, plain_k3_launches):
    """The same gradient with every table apply going through _CsrMatvec
    (the route of CUDA tensors): each P and R runs its partner in the
    backward, only the CSR mid levels form a transpose, once each."""
    jh, jA, A, mask, _ = box6
    rng = np.random.default_rng(32)
    r, w = rng.normal(size=mask.shape[0]), rng.normal(size=mask.shape[0])
    h = amg.from_reference(jh)
    got = v_cycle_grad(h, A, r, w)
    ref = jax.grad(lambda rr: jnp.sum(w * j_amg.v_cycle(jh, jA, rr)))(
        jnp.asarray(r))
    assert rel_by_part(got, ref, mask) <= 1e-10
    n_ops = sum(lv.op is not None for lv in h.levels)
    assert n_ops >= 1
    assert plain_k3_launches["csr_transpose"] == n_ops
    # every forward apply has one backward apply in x
    fwd = plain_k3_launches["csr_matvec"] // 2
    v_cycle_grad(h, A, r, w)
    assert plain_k3_launches["csr_matvec"] == 4 * fwd
    assert plain_k3_launches["csr_transpose"] == n_ops
    assert plain_k3_launches["csr_data_grad"] == 0


@pytest.mark.parametrize("fault", ["scaled by 1.01", "zero"])
def test_v_cycle_gradient_check_sees_a_wrong_x_bar(box6, plain_k3_launches,
                                                   monkeypatch, fault):
    """The comparison above fails when _CsrMatvec's gradient in x is wrong:
    with every K3 backward in x scaled by 1.01, or zero, the free DOFs'
    gradient is far off, while one maximum over all DOFs would move by
    less than the free entries' share of it."""
    jh, jA, A, mask, _ = box6
    rng = np.random.default_rng(32)
    r, w = rng.normal(size=mask.shape[0]), rng.normal(size=mask.shape[0])
    right = cuda_kernels._CsrMatvec.backward
    factor = 1.01 if fault == "scaled by 1.01" else 0.0

    def wrong(ctx, grad):
        g_data, g_x = right(ctx, grad)[2:4]
        return None, None, g_data, factor * g_x, None, None

    monkeypatch.setattr(cuda_kernels._CsrMatvec, "backward",
                        staticmethod(wrong))
    got = v_cycle_grad(amg.from_reference(jh), A, r, w)
    ref = jax.grad(lambda rr: jnp.sum(w * j_amg.v_cycle(jh, jA, rr)))(
        jnp.asarray(r))
    assert rel_by_part(got, ref, mask) > 1e-2
    free = ~mask.numpy()
    assert rel_max(got, ref) < 1e-6 * rel_max(got[free], np.asarray(ref)[free])


@pytest.mark.cuda
def test_k1_coord_grad_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for ne in (1, 37, 4096):
            _, (x, lam, mu, W) = hex_batch(ne, ne, True, device="cuda",
                                           dtype=dtype)
            xg = x.clone().requires_grad_()
            before = cuda_kernels.launches["hex8_stiffness_coord_grad"]
            (got,) = torch.autograd.grad(
                (W * cuda_kernels.hex8_stiffness(xg, lam, mu)).sum(), xg)
            assert cuda_kernels.launches[
                "hex8_stiffness_coord_grad"] == before + 1
            ref = cuda_kernels.hex8_stiffness_coord_grad_plain(
                x.double(), lam.double(), mu.double(), W.double())
            assert rel_max(got.double(), ref) <= tol
            again = cuda_kernels._hex8_coord_grad_launch(x, lam, mu, W)
            assert torch.equal(got, again)


@pytest.mark.cuda
def test_k3_backward_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")
    t64, A, rng = uneven_table(24, n=5000, ncols=4000)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        t = amg.Csr(t64.indptr.cuda(), t64.indices.cuda(),
                    t64.data.to("cuda", dtype), t64.ncols, t64.lanes)
        x = torch.as_tensor(rng.normal(size=A.shape[1]), dtype=dtype,
                            device="cuda", requires_grad=True)
        gy = torch.as_tensor(rng.normal(size=A.shape[0]), dtype=dtype,
                             device="cuda")
        data = t.data.requires_grad_()
        before = dict(cuda_kernels.launches)
        got = torch.autograd.grad(t(x), [x, data], gy)
        assert cuda_kernels.launches["csr_matvec"] == before["csr_matvec"] + 2
        assert cuda_kernels.launches["csr_data_grad"] == before[
            "csr_data_grad"] + 1
        ref = torch.autograd.grad(cuda_kernels.csr_matvec_plain(
            t.indptr, t.indices, data, x), [x, data], gy)
        for g, r in zip(got, ref):
            assert rel_max(g, r) <= tol
        assert all(torch.equal(g, a) for g, a in zip(
            got, torch.autograd.grad(t(x), [x, data], gy)))


@pytest.mark.cuda
def test_v_cycle_gradient_on_card(box6):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")
    jh, _, A_cpu, mask, jp = box6
    rng = np.random.default_rng(33)
    r, w = rng.normal(size=mask.shape[0]), rng.normal(size=mask.shape[0])
    ref = v_cycle_grad(amg.from_reference(jh), A_cpu, r, w)
    before = dict(cuda_kernels.launches)
    got = v_cycle_grad(amg.from_reference(jh, device="cuda"),
                       masked_fused(jp, "cuda")[0],
                       torch.as_tensor(r, device="cuda"),
                       torch.as_tensor(w, device="cuda"))
    # as many K3 launches in the backward as in the forward
    k3 = cuda_kernels.launches["csr_matvec"] - before["csr_matvec"]
    assert k3 > 0 and k3 % 2 == 0
    assert rel_by_part(got, ref, mask) <= 1e-10
