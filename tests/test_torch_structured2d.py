"""The 2D structured row of fem_tpu_torch against fem_tpu, on the CPU in
float64: K2's 2D tables and their plain form (the collapsed 9-point
stencil) against fem_tpu's structured.matvec_planes27 and matvec_matmul,
the operator's dispatch to the K2 wrapper, stepper.run on quad boxes, the
reference's make_example strip through both CLIs, and the slab-sharded row
on a 2D grid. The same inputs are made from a seed with numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_tpu.cli import main as j_cli_main
from fem_tpu.config import Config as JConfig
from fem_tpu.io import meshgen as j_meshgen
from fem_tpu.ops import structured as j_structured
from fem_tpu.ops.stiffness import lame as j_lame
from fem_tpu.solver import stepper as j_stepper
from fem_tpu_torch.cli import main as cli_main
from fem_tpu_torch.config import Config
from fem_tpu_torch.io import meshgen, vtk
from fem_tpu_torch.models import problem as problem_mod
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.ops import cuda_kernels, structured
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.solver import multigrid, stepper

torch.set_num_threads(1)

LAM, MU = j_lame(200e9, 0.3)
CELLS = (0.1, 0.2)
# the grids of chip_smoke.py's 2D kernel phase that fit a CPU test: non-square
# both ways round, and axes of two nodes and of one (no cell: K.u = 0)
SHAPES = [(9, 7), (7, 9), (65, 33), (33, 65)]
DEGENERATE = [(2, 2), (3, 2), (1, 4), (2, 9)]


def rel(a, b):
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pair(shape, cells=CELLS):
    """The same scalar-material 2D operator from both packages."""
    jop = j_structured.build(cells, shape, jnp.asarray(LAM), jnp.asarray(MU),
                             dtype=np.float64)
    op = structured.build(cells, shape, torch.tensor(float(LAM),
                                                     dtype=torch.float64),
                          torch.tensor(float(MU), dtype=torch.float64),
                          dtype=torch.float64, device="cpu")
    return op, jop


# ---------------- K2's 2D tables and their plain form ----------------


def test_2d_interior_table_matches_fem_tpu_csum():
    op, jop = pair((9, 7))
    offsets, A, B, V = j_structured._pair_tables(2)
    k = np.asarray(jop.lam * jop.k_lam + jop.mu * jop.k_mu).reshape(4, 2, 4, 2)
    csum = (k[A, :, B, :] * V[:, :, None, None]).sum(axis=1)  # (9, 2, 2)
    assert op.tables.coef.shape == (9, 9, 2, 2) and op.tables.centre == 4
    got = op.tables.coef[4].numpy()
    assert np.abs(got - csum).max() <= 1e-13 * np.abs(csum).max()
    np.testing.assert_array_equal(op.tables.interior.numpy(), got.reshape(-1))
    assert cuda_kernels.stencil_offsets(2) == offsets


@pytest.mark.parametrize("shape", SHAPES + DEGENERATE)
def test_stencil9_plain_matches_fem_tpu(shape):
    """The 2D tables' plain form against fem_tpu's collapsed 9-point form
    and its default gather / matmul / scatter form, and against the port's
    per-corner form (1e-12 of the largest entry)."""
    op, jop = pair(shape)
    u = np.random.default_rng(0).standard_normal(op.ndof)
    got = cuda_kernels.stencil9_plain(op.tables, torch.as_tensor(u)).numpy()
    refs = [np.asarray(j_structured.matvec_planes27(jop, jnp.asarray(u))),
            np.asarray(j_structured.matvec_matmul(jop, jnp.asarray(u))),
            cuda_kernels.stencil_matvec_plain(op.k_ref, torch.as_tensor(u),
                                              shape).numpy()]
    if 1 in shape:
        assert not got.any() and not any(r.any() for r in refs)
        return
    scale = np.abs(refs[1]).max()
    for ref in refs:
        assert np.abs(got - ref).max() <= 1e-12 * scale


def test_stencil_plain_forms_refuse_the_other_dimension():
    op2, _ = pair((5, 4))
    op3 = structured.build((0.1, 0.2, 0.3), (4, 3, 3),
                           torch.tensor(float(LAM), dtype=torch.float64),
                           torch.tensor(float(MU), dtype=torch.float64),
                           dtype=torch.float64, device="cpu")
    u2, u3 = (torch.zeros(op.ndof, dtype=torch.float64) for op in (op2, op3))
    with pytest.raises(ValueError, match="2D tables"):
        cuda_kernels.stencil9_plain(op3.tables, u3)
    with pytest.raises(ValueError, match="3D tables"):
        cuda_kernels.stencil27_plain(op2.tables, u2)


# ---------------- the operator's dispatch ----------------


def test_2d_matvec_goes_through_the_k2_wrapper(monkeypatch):
    """structured.matvec on a 2D scalar operator calls the K2 wrapper with
    the operator's 2D tables, and never the per-corner form."""
    op, jop = pair((9, 7))
    calls = []
    wrapper = cuda_kernels.stencil_matvec

    def counted(t, u):
        calls.append(t.shape)
        return wrapper(t, u)

    def refused(*a):
        raise AssertionError("the per-corner form is on the path")

    monkeypatch.setattr(cuda_kernels, "stencil_matvec", counted)
    monkeypatch.setattr(cuda_kernels, "stencil_matvec_plain", refused)
    u = np.random.default_rng(1).standard_normal(op.ndof)
    got = structured.matvec(op, torch.as_tensor(u))
    assert calls == [(9, 7)]
    assert rel(got, j_structured.matvec(jop, jnp.asarray(u))) < 1e-12
    g = structured.matvec_g(op, torch.as_tensor(u).reshape(9, 7, 2))
    assert g.shape == (9, 7, 2) and len(calls) == 2


@pytest.mark.parametrize("shape,entry,key", [
    ((9, 7), "stencil_matvec2d", "stencil_matvec_2d"),
    ((7, 9), "stencil_matvec2d", "stencil_matvec_2d"),
    ((5, 4, 3), "stencil_matvec", ""),
])
def test_k2_launch_picks_the_entry_point_by_dimension(monkeypatch, shape,
                                                      entry, key):
    """_k2_launch hands the kernel the grid in the tables' axis order ((ny,
    nx) in 2D) and counts a 2D launch under its own name; the launch itself
    is recorded here, since the kernel has no CPU mode."""
    seen = []
    monkeypatch.setattr(cuda_kernels, "_launch",
                        lambda name, like, *args, key="": seen.append(
                            (name, args[4:], key)))
    cells = (0.1, 0.2, 0.3)[:len(shape)]
    op = structured.build(cells, shape, torch.tensor(1.5, dtype=torch.float64),
                          torch.tensor(1.0, dtype=torch.float64),
                          dtype=torch.float64, device="cpu")
    cuda_kernels._k2_launch(op.tables, torch.zeros(op.ndof,
                                                   dtype=torch.float64))
    assert seen == [(entry, shape, key)]
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels._k2_launch(op.tables, torch.zeros(op.ndof + 2,
                                                       dtype=torch.float64))


def test_2d_k2_autograd_function_backward(monkeypatch):
    """K2's autograd Function on 2D tables, its launches replaced by the
    plain form: the gradient of <W, K u> in u is K W, made by one more
    launch, and it equals the plain form's autograd."""
    calls = []

    def plain_launch(t, u):
        calls.append(t.shape)
        return cuda_kernels.stencil9_plain(t, u)

    monkeypatch.setattr(cuda_kernels, "_k2_launch", plain_launch)
    op, _ = pair((7, 9))
    rng = np.random.default_rng(4)
    u, W = (torch.as_tensor(rng.standard_normal(op.ndof)) for _ in range(2))
    u.requires_grad_()
    (got,) = torch.autograd.grad(
        (W * cuda_kernels._StencilMatvec.apply(op.tables, u)).sum(), u)
    assert calls == [(7, 9)] * 2
    (ref,) = torch.autograd.grad(
        (W * cuda_kernels.stencil9_plain(op.tables, u)).sum(), u)
    assert rel(got, ref) < 1e-13
    assert rel(got, cuda_kernels.stencil9_plain(op.tables, W.detach())) < 1e-13


def test_2d_tables_on_every_mg_level():
    """The coarse levels multigrid.build makes on a 2D grid (33 x 65 nodes
    down to 3 x 5) carry their own 2D tables, which apply as the per-corner
    form does."""
    op, _ = pair((33, 65), (1 / 64, 1 / 32))
    bc = torch.arange(0, 33 * 65 * 2, 65 * 2)  # x = 0 edge, x component
    h = multigrid.build(op, bc)
    assert [lv.op.shape for lv in h.levels] == [(33, 65), (17, 33), (9, 17),
                                                (5, 9), (3, 5)]
    for i, lv in enumerate(h.levels):
        assert lv.op.tables.shape == lv.op.shape
        u = torch.as_tensor(np.random.default_rng(i).standard_normal(
            lv.op.ndof))
        corner = cuda_kernels.stencil_matvec_plain(lv.op.k_ref, u,
                                                   lv.op.shape)
        assert rel(structured.matvec(lv.op, u), corner) < 1e-13
    coarse = dataclasses.replace(op, shape=(17, 33))
    assert coarse.tables.shape == (17, 33)


# ---------------- the stepper row ----------------


def same(got, ref, tol=1e-9):
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("nx,ny,levels", [(32, 16, 4), (24, 10, 2)],
                         ids=["coarsens_to_5x3_nodes", "stops_on_odd_count"])
def test_quad_box_matches_fem_tpu_mg_cg(monkeypatch, nx, ny, levels):
    """stepper.run on a clamped quad cantilever through structured_mg_cg
    against fem_tpu's: the same MG-CG iterations, u and nodal stress to
    1e-9 relative; every K.u of the solve goes through the K2 wrapper (one
    2D grid per MG level) and, on the CPU, launches nothing."""
    jp = j_meshgen.quad_grid_problem(nx, ny, lx=2.0, ly=1.0, E=100.0, nu=0.3,
                                     tip_force=(0.0, -1.0))
    jr = j_stepper.run(jp, JConfig(solver="cg"))
    grids = set()
    wrapper = cuda_kernels.stencil_matvec

    def counted(t, u):
        grids.add(t.shape)
        return wrapper(t, u)

    monkeypatch.setattr(cuda_kernels, "stencil_matvec", counted)
    cuda_kernels.reset_launches()
    r = stepper.run(Problem.from_reference(jp), Config(device="cpu",
                                                       solver="cg"))
    assert r.path == "structured_mg_cg"
    assert r.krylov_iters == [int(i) for i in jr.krylov_iters]
    assert same(r.aggregate_u, np.asarray(jr.aggregate_u))
    assert same(r.aggregate_stress, np.asarray(jr.aggregate_stress))
    assert len(grids) == levels and (ny + 1, nx + 1) in grids
    assert not any(cuda_kernels.launches.values())


@pytest.mark.parametrize("args", [[], ["--solver", "cg"]],
                         ids=["default_direct", "structured_mg_cg"])
def test_make_example_strip_through_both_clis(tmp_path, monkeypatch, args):
    """The reference's make_example strip (64 x 4 unit quads, two pinned
    corners, two end forces) through both CLIs: the VTKs hold the same
    fields (1e-9 of the largest); with --solver cg the port's run takes
    structured_mg_cg."""
    deck = tmp_path / "strip.inp"
    deck.write_text(meshgen.quad_strip_deck(64, 4))
    assert j_meshgen.quad_strip_deck(64, 4) == deck.read_text()
    fields = {}
    for name, main, extra in (("jax", j_cli_main, []),
                              ("torch", cli_main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(["-f", str(deck), "-q", *extra, *args]) == 0
        fields[name] = vtk.read_fields(str(tmp_path / name
                                           / "0_output_000000.vtk"))
    for got, ref in zip(fields["torch"], fields["jax"]):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-9 * max(np.abs(ref).max(), 1.0)
    if args:
        msgs = []
        r = stepper.run(problem_mod.load(str(deck)),
                        Config(device="cpu", solver="cg"), log=msgs.append)
        assert r.path == "structured_mg_cg"
        assert any("Structured grid detected" in m for m in msgs)


@pytest.mark.parametrize("shards,sizes", [(4, [2, 2, 2, 2]), (3, [3, 3, 2])],
                         ids=["4_equal_slabs", "3_unequal_slabs"])
def test_2d_slab_stencil_matches_single_device(monkeypatch, shards, sizes):
    """The 2D slab-sharded row: slabs along y, the leading axis of the (ny,
    nx) node grid. matvec_sharded equals matvec (1e-12); the
    sharded stepper run takes the single-device run's iterations and its u
    (1e-9), and K2's wrapper runs on every slab grid."""
    p = meshgen.quad_grid_problem(16, 8, lx=2.0, ly=1.0, E=100.0, nu=0.3,
                                  tip_force=(0.0, -1.0))
    spec = structured.detect(p)
    assert spec["node_shape"] == (9, 17)
    op = structured.build(spec["cell_sizes"], spec["node_shape"],
                          torch.tensor(1.5, dtype=torch.float64),
                          torch.tensor(1.0, dtype=torch.float64),
                          dtype=torch.float64, device="cpu")
    mesh = mesh_mod.make_mesh(shards, device="cpu")
    sl = structured.shard_slabs(op, mesh)
    assert [e - s for s, e in sl.bounds] == sizes
    assert all(lop.tables.shape == lop.shape for lop in sl.ops)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(op.ndof))
    ref = structured.matvec(op, u)
    assert rel(structured.matvec_sharded(sl, u), ref) < 1e-12

    single = stepper.run(p, Config(device="cpu", solver="cg", rtol=1e-12))
    grids = []
    wrapper = cuda_kernels.stencil_matvec

    def counted(t, v):
        grids.append(t.shape)
        return wrapper(t, v)

    monkeypatch.setattr(cuda_kernels, "stencil_matvec", counted)
    msgs = []
    r = stepper.run(p, Config(device="cpu", solver="cg", rtol=1e-12,
                              n_devices=shards), log=msgs.append)
    assert (single.path, r.path) == ("structured_mg_cg",
                                     "sharded_slab_stencil")
    assert any("MG fine level sharded over the slab mesh" in m for m in msgs)
    assert r.krylov_iters == single.krylov_iters
    assert same(r.aggregate_u, single.aggregate_u)
    assert {(c + 1, 17) for c in sizes} <= set(grids)
