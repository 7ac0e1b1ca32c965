"""Incremental quasi-static time stepping — the time loop.

Port of `fem_tpu.solver.stepper.run` (fem_tpu `solver/stepper.py:226-1337`,
single device). Mirrors main.F90:216-296: for interval k = 1,2,...,
t_init = dt*(k-1) until t_init >= t; each step forms the time-windowed RHS,
solves (a linear solve, or one Newton solve on cohesive decks, logged as
"SNES Iteration Count"), and accumulates aggregate_u += du and
aggregate_stress += nodal stress of the increment.
`stype == "explicit"` performs no solve and writes zeros, like the reference
(main.F90:199,238).

The solver path is chosen by one table, PATHS: the first row whose predicate
holds for the problem's features names the path. Every setup returns one
step(F, du_prev, aggregate_u, t_end) -> Increment.

Config.n_devices > 1 (the reference's `mpiexec -n N`, fem_tpu
`stepper.py:294-314,380-446,562-1011`) shards the solve over a device mesh
(parallel/mesh.py), by the tier that fits the deck:
  - a structured box: cell slabs of the stencil, u replicated, one all-reduce
    per K.u, and the V-cycle's fine level on the same slabs
    (`sharded_slab_stencil`);
  - a lex-lattice AMG deck: the block stencil's rows and the Krylov vectors
    in slabs of node planes, two planes per K.u
    (`sharded_halo_block_stencil`);
  - any other AMG deck: the halo-gather tier (parallel/halo_gather.py, the
    vectors in slabs of the coordinate order, four bands per K.u) where the
    mesh has one element type and slab locality, else the element-sharded
    operator (parallel/ops.ShardedOperator, one all-reduce per K.u)
    (`sharded_amg_cg`);
  - below the AMG threshold, and under the matrix-free Newton of a cohesive
    deck (either residual form): the element-sharded operator.
Direct solves, the dense Newton forms among them, and explicit runs ignore
it, as in fem_tpu.

Viscoelastic creep (Config.viscoelastic) is not a path: on every linear row
it adds System.creep_force of the per-ip creep state to the step's RHS, and
after the solve it updates that state and makes aggregate_stress its nodal
average (fem_tpu `stepper.py:1259-1262,1311-1316`). The run checkpoints its
state every `checkpoint_every` steps and resumes from the newest checkpoint
(fem_tpu `stepper.py:251-292,1319-1323`), times its phases (StepResult.
timers) and, with Config.profile_dir, records a torch.profiler trace.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from fem_tpu_torch.config import Config
from fem_tpu_torch.models.problem import Problem
from fem_tpu_torch.models.system import PENALTY, System
from fem_tpu_torch.ops import blockstencil, structured
from fem_tpu_torch.parallel import halo_gather
from fem_tpu_torch.parallel import mesh as mesh_mod
from fem_tpu_torch.parallel.ops import ShardedOperator
from fem_tpu_torch.solver import amg, cg, direct, hierarchy, multigrid, newton
from fem_tpu_torch.utils import checkpoint, timing
from fem_tpu_torch.utils.timing import Timers, device_trace


@dataclasses.dataclass(frozen=True)
class Features:
    """What the path choice reads from a problem and a config."""

    explicit: bool
    cohesive: bool
    sharded: bool
    solver: str  # "direct" | "cg"
    structured: bool
    precond: str  # "jacobi" | "amg"
    # whether the assembled connectivity is a lex lattice; it costs an
    # assembly, so it is a call, made only by the row that asks
    lattice: Callable[[], bool] = lambda: False


# (path name, predicate on Features). A cohesive deck shards its elastic
# operator inside its own row.
PATHS = (
    ("explicit", lambda f: f.explicit),
    ("cohesive_newton", lambda f: f.cohesive),
    ("direct", lambda f: f.solver == "direct"),
    ("sharded_slab_stencil", lambda f: f.sharded and f.structured),
    ("sharded_halo_block_stencil",
     lambda f: f.sharded and f.precond == "amg" and f.lattice()),
    ("sharded_amg_cg", lambda f: f.sharded and f.precond == "amg"),
    ("sharded_jacobi_cg", lambda f: f.sharded),
    ("structured_mg_cg", lambda f: f.structured),
    ("unstructured_amg_or_lattice_gmg_cg", lambda f: f.precond == "amg"),
    ("unstructured_jacobi_cg", lambda f: True),
)


def choose_path(f: Features) -> str:
    for name, applies in PATHS:
        if applies(f):
            return name
    raise AssertionError("the last row of PATHS always applies")


@dataclasses.dataclass
class StepResult:
    aggregate_u: np.ndarray  # (ndof,)
    aggregate_stress: np.ndarray  # (nnds, cpdim)
    du: np.ndarray  # last increment
    krylov_iters: List[int]  # per step; inner iterations on cohesive decks
    nsteps: int
    path: str
    # per step, cohesive decks only: Newton iterations, whether Newton met
    # its tolerance, the inner solves that took the GMRES fallback, and the
    # residual evaluations (line-search trials included)
    newton_iters: List[int] = dataclasses.field(default_factory=list)
    newton_converged: List[bool] = dataclasses.field(default_factory=list)
    gmres_fallbacks: List[int] = dataclasses.field(default_factory=list)
    newton_residuals: List[int] = dataclasses.field(default_factory=list)
    # phase wall-clock totals (setup, rhs, solve or newton, stress) and the
    # run's span tree and counters
    timers: Optional[Timers] = None


class Increment(NamedTuple):
    """What one load step's solve hands the time loop."""

    du: torch.Tensor
    iters: Optional[int]  # Krylov iterations (inner ones under Newton);
    # None after a direct solve
    newton: Optional[newton.NewtonResult] = None  # cohesive decks


def _setup_direct(system: System, config: Config, solver: str, spec, log):
    """Dense LU once; per step a penalty or eliminated RHS."""
    bc_mode = config.resolve_bc_mode(solver)
    bc = system.bc_dofs
    K = system.dense_K()
    kscale = float(K.abs().max())  # physical, pre-penalty
    zero = torch.zeros_like(K[0])
    if bc_mode == "penalty":
        Kb, _ = direct.apply_penalty_bcs(K, zero, bc, system.bc_step_vals(),
                                         PENALTY)
    else:
        Kb, _ = direct.eliminate_bcs(K, zero, bc, system.bc_step_vals())
    fac = direct.factorize(Kb)
    # the reference prints the determinant after every factorization
    # (main.F90:379-390)
    m, e, nn = direct.det_report(fac, ref_scale=kscale)
    log(f"    Direct LU: det(K) = {m:.6f} * 2^{e}"
        + (f", {nn} null pivot(s)" if nn else ""))
    bc_vals = system.bc_step_vals()

    def step(F, du_prev, aggregate_u, t_end):
        if bc_mode == "penalty":
            Fb = F.clone()
            Fb[bc] = PENALTY * bc_vals
        else:
            ubc = torch.zeros_like(F)
            ubc[bc] = bc_vals
            Fb = F - K @ ubc
            Fb[bc] = bc_vals
        return Increment(direct.solve_factorized(fac, Fb), None)

    return step


def _setup_structured(system: System, config: Config, solver: str, spec,
                      log):
    """Stencil operator + Chebyshev-smoothed geometric multigrid + PCG in the
    config dtype at every size, warm-started from the last increment (the
    reference never zeroes Vec_U; fem_tpu's stepper.py:506-509,545-553); with
    Config.n_devices > 1 on cell slabs over the device mesh.

    fem_tpu solves decks above its `structured_big_threshold` with a float32
    inner MG-CG under float64 refinement, because a TPU emulates float64.
    The H100 computes float64 natively, and the port measured that split on
    the 80^3 box (1,594,323 DOFs; NVIDIA H100 80GB HBM3 at 700.00 W, both
    sides to a true relative residual <= 1e-9, medians of 7 solves): this
    float64 solve 75.43 ms (70.87-77.72; 12 iterations), the refinement
    137.89 ms (123.29-162.97; 20 inner iterations in 3 cycles) at an inner
    tolerance of 1e-4 and 107.85 ms (101.71-116.58; 16 in 3) at 1e-3. The
    solve is bound by kernel launches, whose number follows the iterations
    and not the dtype, so the port solves in the config dtype only."""
    log("    Structured grid detected: stencil + multigrid path")
    dtype, dev = system.dtype, system.device
    with timing.span("operator"):
        op = structured.operator_for(system, spec)
    with timing.span("hierarchy"):
        hier = multigrid.build(op, system.bc_dofs)
    if config.n_devices and config.n_devices > 1:
        # fem_tpu's stepper.py:380-446: the CG's K.u and the V-cycle's fine
        # level run on cell slabs of the leading axis, u replicated, one
        # all-reduce per K.u. fem_tpu pads a cell count that the device
        # count does not divide with zero-material phantom cells (per-cell
        # fields on every shard) and leaves that run's V-cycle unsharded;
        # slabs here may differ by one cell, so every shard keeps the scalar
        # operator (K2) and the fine level is sharded either way
        mesh = _make_mesh(system, config, log)
        slabs = structured.shard_slabs(op, mesh)
        sizes = [e - s for s, e in slabs.bounds]
        log("    Stencil matvec sharded (slab + psum halo)"
            if len(set(sizes)) == 1 else
            f"    Stencil matvec sharded ({sum(sizes)} cells in unequal slabs "
            f"of {sizes} over {mesh.size} devices)")
        log("    MG fine level sharded over the slab mesh")

        def raw(v):
            return structured.matvec_sharded(slabs, v)

        pc = multigrid.preconditioner(hier, raw)
    else:
        def raw(v):
            return structured.matvec(op, v)

        pc = multigrid.preconditioner(hier)
    bc_mask = torch.zeros(system.ndof, dtype=torch.bool, device=dev)
    bc_mask[system.bc_dofs] = True
    masked = cg.masked_operator(raw, bc_mask)
    mf = bc_mask.to(dtype)
    ubc = torch.zeros(system.ndof, dtype=dtype, device=dev)
    ubc[system.bc_dofs] = system.bc_step_vals()

    def step(F, du_prev, aggregate_u, t_end):
        b = cg.constrained_rhs(raw, F, bc_mask, ubc)
        # warm start (the reference never zeroes Vec_U)
        res = cg.pcg(masked, b, x0=torch.where(bc_mask, ubc, du_prev),
                     precond=pc,
                     rtol=config.rtol or 1e-9, atol=config.atol,
                     maxiter=config.maxiter or 400)
        return Increment(res.x * (1.0 - mf) + ubc * mf, res.iters)

    return step


class _Sharded(NamedTuple):
    """What a sharded row gives _setup_unstructured in place of its own."""

    fine: Callable  # v -> K_el v, on the state the layout makes
    # DOF-sharded tiers: the solve's vectors are ShardedVectors from its
    # start to its end; None where the state stays a tensor on shard 0
    layout: Optional[mesh_mod.SlabLayout] = None
    # halo-gather: the state and the hierarchy are in slab order,
    # v_slab = v[order]; bc_dofs and coords are the system's in that order
    order: Optional[torch.Tensor] = None
    bc_dofs: Optional[np.ndarray] = None
    coords: Optional[np.ndarray] = None
    gmg: bool = True  # whether a lattice may take GMG


def _setup_unstructured(system: System, config: Config, solver: str, spec,
                        log, A_csr=None, sharded: Optional[_Sharded] = None):
    """Unstructured meshes at scale, the any-mesh half of MUMPS' role
    (main.F90:354-390; fem_tpu's stepper.py:1012-1237 in float64 at every
    size): the assembled CSR on the host picks the fine operator (a block
    stencil when the connectivity is a lex lattice, else the fused
    gather/scatter operator) and the preconditioner (geometric lattice MG on
    lattices above `gmg_min` DOFs, else SA-AMG with a dense coarse inverse
    up to 20,000 DOFs) of a masked PCG, warm-started from the last
    increment. A GMG solve that ends non-finite or unconverged demotes the
    run to SA-AMG and solves again. A sharded row gives its operator in the
    fine operator's place (`sharded`) and the matrix it assembled (`A_csr`,
    in the state's order); on a DOF-sharded row the vectors enter the
    row's layout when a step's solve begins and leave it when it ends."""
    log("    AMG preconditioner (smoothed aggregation)")
    dtype, dev = system.dtype, system.device
    n = system.ndof
    sh = sharded or _Sharded(fine=None)
    t_asm = "by the path choice"
    if A_csr is None:
        with timing.span("assemble") as s_asm:
            A_csr = amg.assemble_csr(system)
        t_asm = f"{s_asm.seconds:.2f} s"
    fh = hierarchy.build(system, A_csr,
                         gmg_min=config.gmg_min if sh.gmg else n,
                         coarse_max=20000, fine=sh.fine, bc_dofs=sh.bc_dofs,
                         coords=sh.coords)
    del A_csr
    if fh.dims is not None and sharded is None:
        log("    Lattice topology: block-stencil fine operator")
    if fh.kind == "gmg":
        log("    Geometric lattice-MG preconditioner")
    log(f"    Unstructured set-up: assemble_csr {t_asm}, operator "
        f"{fh.spans['operator'].seconds:.2f} s, hierarchy "
        f"{fh.spans['hierarchy'].seconds:.2f} s, level sizes {fh.sizes}")
    fine = fh.fine
    bc_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    bc_mask[system.bc_dofs] = True
    mf = bc_mask.to(dtype)
    ubc = torch.zeros(n, dtype=dtype, device=dev)
    ubc[system.bc_dofs] = system.bc_step_vals()

    def enter(v):
        """A flat vector of the deck into the solve's state."""
        if sh.layout is None:
            return v
        return sh.layout.scatter(v if sh.order is None else v[sh.order])

    def leave(v):
        if sh.layout is None:
            return v
        v = sh.layout.gather(v)
        if sh.order is None:
            return v
        return torch.empty_like(v).index_copy_(0, sh.order, v)

    mask_s, ubc_s = enter(bc_mask), enter(ubc)
    masked = cg.masked_operator(fine, mask_s)
    state = {"pc": fh.preconditioner(masked, sh.layout),
             "gmg": fh.kind == "gmg"}
    cap = config.maxiter or 400

    def pcg(b, x0):
        return cg.pcg(masked, b, x0=x0, precond=state["pc"],
                      rtol=config.rtol or 1e-9, atol=config.atol,
                      maxiter=cap)

    def step(F, du_prev, aggregate_u, t_end):
        b = cg.constrained_rhs(fine, enter(F), mask_s, ubc_s)
        x0 = enter(torch.where(bc_mask, ubc, du_prev))
        res = pcg(b, x0)
        if state["gmg"] and not (math.isfinite(res.resnorm)
                                 and res.iters < cap):
            log("    GMG acceptance FAILED ("
                + ("non-finite residual" if not math.isfinite(res.resnorm)
                   else f"{res.iters} inner iterations")
                + ") -> SA-AMG demotion")
            h = amg.build(system, system.bc_dofs, coarse_max=20000)
            state.update(pc=amg.preconditioner(h, masked, sh.layout),
                         gmg=False)
            res = pcg(b, x0)
        return Increment(leave(res.x) * (1.0 - mf) + ubc * mf, res.iters)

    return step


def _setup_jacobi(system: System, config: Config, solver: str, spec, log):
    """Matrix-free System.matvec with Jacobi-PCG, warm-started from the last
    increment (the reference never zeroes Vec_U)."""
    d = system.diag()
    bc_vals = system.bc_step_vals()

    def step(F, du_prev, aggregate_u, t_end):
        res = cg.solve_eliminated(system.matvec, F, d, system.bc_dofs,
                                  bc_vals, x0=du_prev, rtol=config.rtol,
                                  atol=config.atol, maxiter=config.maxiter)
        return Increment(res.x, res.iters)

    return step


def _make_mesh(system: System, config: Config, log) -> mesh_mod.DeviceMesh:
    """The mesh of config.n_devices shards (the reference's
    `mpiexec -n <cores>`, main.F90:32)."""
    mesh = mesh_mod.make_mesh(config.n_devices, device=system.device)
    log(f"    Sharding over {config.n_devices} devices ({mesh.describe()})")
    return mesh


def _sharded_operator(system: System, config: Config, log) -> ShardedOperator:
    """The elastic operator sharded by elements over config.n_devices."""
    return ShardedOperator(system, _make_mesh(system, config, log))


def _setup_sharded_jacobi(system: System, config: Config, solver: str, spec,
                          log):
    """_setup_jacobi on the element-sharded fused operator (fem_tpu's
    stepper.py:999-1011): the CG vector algebra stays replicated."""
    sop = _sharded_operator(system, config, log)
    log("    Fused operator sharded over the device mesh")
    d = sop.diag()
    bc_vals = system.bc_step_vals()

    def step(F, du_prev, aggregate_u, t_end):
        res = cg.solve_eliminated(sop.matvec, F, d, system.bc_dofs, bc_vals,
                                  x0=du_prev, rtol=config.rtol,
                                  atol=config.atol, maxiter=config.maxiter)
        return Increment(res.x, res.iters)

    return step


def _setup_halo_block(system: System, config: Config, solver: str, A_csr,
                      log):
    """A lex-lattice AMG deck over several devices (fem_tpu's
    stepper.py:562-730, in float64 throughout): the block stencil's rows and
    the Krylov vectors lie in slabs of node planes, one slab per shard, and
    every fine K.u, the CG's and the V-cycle smoother's alike, moves two
    node planes. The hierarchy is the single-device row's (lattice GMG above
    `gmg_min` DOFs, else SA-AMG, the demotion kept); its coarse levels lie
    on shard 0, and the cycle gathers the fine residual and scatters the
    prolonged correction."""
    mesh = _make_mesh(system, config, log)
    log("    Lattice topology: DOF-sharded halo block stencil")
    dims = blockstencil.detect(A_csr, system.pdim, system.nnds)
    hop = blockstencil.shard_rows(
        blockstencil.build(A_csr, system.pdim, dims, dtype=system.dtype,
                           device=system.device), mesh)

    def fine(v):
        return mesh_mod.ShardedVector(
            mesh, blockstencil.halo_matvec_g(hop, v.parts))

    return _setup_unstructured(system, config, solver, None, log, A_csr=A_csr,
                               sharded=_Sharded(fine, hop.layout()))


def _setup_sharded_amg(system: System, config: Config, solver: str, A_csr,
                       log):
    """A general AMG deck over several devices (fem_tpu's
    stepper.py:731-998, in float64 throughout). Preferred: the DOF-sharded
    halo-gather tier, four (B, pdim) bands per K.u, with SA-AMG built on the
    slab-permuted matrix so that the cycle runs on slab-ordered state with
    no permutation per iteration. Where that layout does not apply (several
    element blocks, or no slab locality): the element-sharded operator, the
    state replicated and one all-reduce per K.u. Either way the coarse
    levels (K3 transfers, dense coarse inverse) lie on shard 0. `A_csr` is
    the matrix the path choice assembled for its lattice check."""
    mesh = _make_mesh(system, config, log)
    try:
        hg, pos = halo_gather.build(system, mesh)
    except ValueError as e:
        log(f"    (halo-gather layout unavailable: {e})")
        log("    Fused operator sharded over the device mesh "
            "(element-sharded tier)")
        log("    AMG preconditioner over the sharded operator")
        sop = ShardedOperator(system, mesh)
        return _setup_unstructured(system, config, solver, None, log,
                                   A_csr=A_csr, sharded=_Sharded(sop.matvec))
    log(f"    DOF-sharded halo-gather operator (S={hg.S}, B={hg.B})")
    log("    AMG preconditioner on the slab-permuted operator")
    pdim = system.pdim
    idx = halo_gather.dof_order(pos, pdim)
    bc = system.bc_dofs.cpu().numpy()

    def fine(v):
        return mesh_mod.ShardedVector(mesh, halo_gather.matvec(hg, v.parts))

    return _setup_unstructured(
        system, config, solver, None, log, A_csr=A_csr[idx][:, idx],
        sharded=_Sharded(
            fine, hg.layout(),
            order=timing.upload(idx, device=system.device),
            bc_dofs=pos[bc // pdim] * pdim + bc % pdim,
            coords=np.asarray(system.problem.coords)[np.argsort(pos)],
            gmg=False))


def _setup_cohesive(system: System, config: Config, solver: str, spec, log):
    """The cohesive Newton path (fem_tpu's stepper.py:1264-1288), one Newton
    solve per step, logged as the reference's "SNES Iteration Count". The
    direct solver takes the dense Newton: the true-equilibrium one under
    formulation "total", else the incremental one (SNES with the MUMPS
    stand-in). The iterative solver takes the matrix-free Newton-Krylov in
    either form, its operators and hierarchy built here, once for the run;
    with Config.n_devices > 1 its elastic products run on the
    element-sharded operator (fem_tpu's stepper.py:303-314; the dense forms
    ignore the mesh). Each step adds its Newton iterations, residual
    evaluations, inner Krylov iterations and GMRES fallbacks to the run's
    counters `newton_iters`, `newton_residuals`, `inner_iters` and
    `gmres_fallbacks`."""
    sublog = lambda m: log("    " + m)  # noqa: E731
    if solver == "direct" and config.formulation == "total":
        def newton_step(F, du, agg, t_end):
            return newton.solve_step_total(system, config, agg, du, t_end)
    elif solver == "direct":
        bc_mode = config.resolve_bc_mode(solver)

        def newton_step(F, du, agg, t_end):
            return newton.solve_step(system, config, agg, du, F,
                                     bc_mode=bc_mode)
    else:
        sop = None
        if config.n_devices and config.n_devices > 1:
            sop = _sharded_operator(system, config, log)
            log("    Nonlinear path: fused operator sharded over the mesh")
        ops = newton.matfree_operators(system, config, log=sublog,
                                       sharded_op=sop)

        def newton_step(F, du, agg, t_end):
            return newton.solve_step_matfree(system, config, agg, du, F,
                                             ops=ops, log=sublog, t_end=t_end)

    def step(F, du_prev, aggregate_u, t_end):
        res = newton_step(F, du_prev, aggregate_u, t_end)
        log(f"    SNES Iteration Count: {res.iters}")
        for name, n in (("newton_iters", res.iters),
                        ("newton_residuals", res.residuals),
                        ("inner_iters", res.inner_iters),
                        ("gmres_fallbacks", res.gmres_fallbacks)):
            timing.count(name, n)
        return Increment(res.du, res.inner_iters, res)

    return step


_SETUP = {
    "cohesive_newton": _setup_cohesive,
    "direct": _setup_direct,
    "sharded_amg_cg": _setup_sharded_amg,
    "sharded_halo_block_stencil": _setup_halo_block,
    "sharded_jacobi_cg": _setup_sharded_jacobi,
    "sharded_slab_stencil": _setup_structured,
    "structured_mg_cg": _setup_structured,
    "unstructured_amg_or_lattice_gmg_cg": _setup_unstructured,
    "unstructured_jacobi_cg": _setup_jacobi,
}


def run(
    problem: Problem,
    config: Optional[Config] = None,
    log: Optional[Callable[[str], None]] = None,
) -> StepResult:
    config = config or Config()
    device = config.torch_device()
    cuda = device.type == "cuda"
    tm = Timers(sync_device=device if config.timing and cuda else None,
                traced=bool(config.timing or config.profile_dir),
                peak_device=device if cuda else None)
    with device_trace(config.profile_dir), tm.active():
        return _run(problem, config, log or (lambda msg: None), tm)


def _run(problem: Problem, config: Config, log, tm: Timers) -> StepResult:
    dtype = config.torch_dtype
    device = config.torch_device()
    n = problem.ndof
    solver = config.resolve_solver(n)
    explicit = problem.stype == "explicit"
    spec = None
    if solver == "cg":
        with tm.span("detect"):
            spec = structured.detect(problem)
    if config.viscoelastic and problem.has_cohesive and not explicit:
        raise NotImplementedError(
            "viscoelastic + cohesive in one run is not supported yet")
    cpdim = 3 if problem.pdim == 2 else 6
    aggregate_u = torch.zeros(n, dtype=dtype, device=device)
    aggregate_stress = torch.zeros((problem.nnds, cpdim), dtype=dtype,
                                   device=device)
    du = torch.zeros(n, dtype=dtype, device=device)
    krylov_iters: List[int] = []
    newton_iters: List[int] = []
    newton_converged: List[bool] = []
    gmres_fallbacks: List[int] = []
    newton_residuals: List[int] = []
    nsteps = problem.nsteps
    first_step = 1
    resumed_creep = None
    if config.checkpoint_dir and config.resume:
        ck_path = checkpoint.latest(config.checkpoint_dir)
        if ck_path is not None:
            (step0, aggregate_u, aggregate_stress, du,
             resumed_creep) = checkpoint.load(ck_path, device=device,
                                              dtype=dtype)
            first_step = step0 + 1
            log(f"Resumed from {ck_path} (next interval {first_step})")

    csr = {}  # the matrix assembled for the lattice check, for the set-up

    def lattice():
        csr["A"] = amg.assemble_csr(system)
        return blockstencil.detect(csr["A"], system.pdim,
                                   system.nnds) is not None

    features = Features(
        explicit=explicit,
        cohesive=problem.has_cohesive,
        sharded=bool(config.n_devices and config.n_devices > 1),
        solver=solver,
        structured=spec is not None,
        precond=config.resolve_precond(n),
        lattice=lattice,
    )
    if explicit:
        path = choose_path(features)
        log(f"    Solver path: {path}")
        for k in range(first_step, nsteps + 1):
            log(f"Interval: {k}")
    else:
        with tm.phase("setup"):
            with tm.span("system"):
                system = System(problem, dtype, device=device,
                                plane_stress=config.plane_stress)
            path = choose_path(features)
            log(f"    Solver path: {path}")
            creep_state = (system.creep_state_init() if config.viscoelastic
                           else {})
            if creep_state and resumed_creep is not None:
                # the per-ip creep stress is part of the restartable state:
                # resuming without it would silently re-zero the history
                if set(resumed_creep) != set(creep_state):
                    raise ValueError(
                        "checkpoint has no creep state for this viscoelastic "
                        "run; it predates creep checkpointing — rerun with "
                        "--no-resume or a fresh --checkpoint-dir")
                creep_state = resumed_creep
            # the sharded AMG row gets the lattice check's matrix
            with tm.span("solver"):
                step = _SETUP[path](system, config, solver,
                                    csr.pop("A", spec), log)
        solve_phase = "newton" if path == "cohesive_newton" else "solve"
        for k in range(first_step, nsteps + 1):
            log(f"Interval: {k}")
            t_init = problem.dt * (k - 1)
            with tm.phase("rhs"):
                F = system.rhs(t_init)
                if creep_state:
                    with tm.span("creep_moduli"):
                        moduli = system.creep_moduli(creep_state)
                    F = F + system.creep_force(creep_state, moduli)
            with tm.phase(solve_phase):
                inc = step(F, du, aggregate_u, t_init + problem.dt)
            du = inc.du
            if inc.iters is not None:
                krylov_iters.append(int(inc.iters))
            if inc.newton is not None:
                newton_iters.append(inc.newton.iters)
                newton_converged.append(inc.newton.converged)
                gmres_fallbacks.append(inc.newton.gmres_fallbacks)
                newton_residuals.append(inc.newton.residuals)
            aggregate_u = aggregate_u + du
            with tm.phase("stress"):
                if creep_state:
                    creep_state = system.creep_stress_update(creep_state, du,
                                                             moduli)
                    # frees D_eff (1.2 GB at 80^3) before the next step
                    # forms its own
                    del moduli
                    aggregate_stress = system.nodal_average_state(creep_state)
                else:
                    aggregate_stress = (aggregate_stress
                                        + system.stress_increment(du))
            if config.checkpoint_dir and k % max(config.checkpoint_every,
                                                 1) == 0:
                checkpoint.save(config.checkpoint_dir, k, aggregate_u,
                                aggregate_stress, du,
                                creep_state=creep_state or None)
    with tm.span("to_host"):
        host = [a.cpu().numpy() for a in (aggregate_u, aggregate_stress, du)]
    if config.timing:
        log("Phase timers:\n" + tm.report())

    return StepResult(
        aggregate_u=host[0],
        aggregate_stress=host[1],
        du=host[2],
        krylov_iters=krylov_iters,
        nsteps=nsteps,
        path=path,
        newton_iters=newton_iters,
        newton_converged=newton_converged,
        gmres_fallbacks=gmres_fallbacks,
        newton_residuals=newton_residuals,
        timers=tm,
    )
