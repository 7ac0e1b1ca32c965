"""Smoke run of fem_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Every kernel is timed four ways beside its bound (the larger of its least
bytes over 3.35 TB/s and its least operations over the FP64 / FP32 peak):
one launch between synchronizations (the times of earlier runs; they hold
the wrapper's host time), launches back to back, one launch after a 256 MB
read that empties the L2 ("cold", the bound's share is taken of it), and
its plain torch version; beside it, where one PyTorch call computes the
same function, that call (cuSPARSE's CSR SpMV through torch.mv), which the
port never calls, timed the same three ways.

Phases, each of which exits non-zero when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from fem_tpu_torch/csrc (nvcc, sm_90a);
  3. kernel K1 (hex8 stiffness) against its plain torch version, float64 and
     float32, at 131,072 jittered elements and at the shapes the main path
     gives it, with its times;
  4. kernel K2 (the collapsed 27-point stencil) against the per-corner
     masked form and its own plain version, float64 and float32, the same
     bits on a second call, on the 81^3 node grid, on (9, 7, 6) and on the
     degenerate grids (2, 2, 2), (3, 2, 9) and (1, 4, 5); then the
     unjittered 55^3 box (56^3 nodes): K2's times beside cuSPARSE on its
     assembled matrix;
  5. the CLI on the elastic golden deck with --device cuda, checked against
     the golden numbers (u_y 0.05 / 0.10, nodal stress 105 / 245 / 0);
  6. a small hex box on the direct path (K1 assembles k_e), checked against
     the same run on the CPU;
  7. stepper.run on the 80^3 hex8 box (1,594,323 DOFs, float64) through the
     structured MG-CG path, with the true relative residual recomputed with
     the per-corner form, its MG-CG iteration count (12, +-1), and the launch
     counts of that run (K2's by MG level); then K2 checked as in phase 4 on
     the operator of every level of that run's multigrid hierarchy (81^3
     down to 6^3, rebuilt by multigrid.build as the stepper builds it), and
     K2's times on the 81^3 grid beside cuSPARSE on the box's assembled
     matrix;
  8. kernel K3 (CSR SpMV) against its plain version, float64 and float32,
     with the same bits on a second call and its times beside cuSPARSE on
     the same CSR, on a random table (n = 200,000, 81 nonzeros a row) and,
     in phase 9, on the real prolongation, restriction and CSR mid-level
     tables of the 526,848-DOF SA-AMG hierarchy and on the box's assembled
     matrix (measured only: the path's fine operator is the fused one);
  9. the permuted, jittered 55^3 hex8 box (526,848 DOFs, float64):
     stepper.run through unstructured_amg_or_lattice_gmg_cg with SA-AMG
     (its log gives the host set-up's phases and level sizes), its launch
     counts, K3 on the tables of the hierarchy that the run built, and the
     true relative residual recomputed with assemble_csr's matrix as a
     torch sparse CSR product;
 10. the same box in lex order through the block stencil and lattice GMG,
     with the same residual check;
 11. the cohesive decks on the card, each against the same run on the CPU:
     examples/ref/cohesive_test_2.inp through the CLI (2 steps, 1 Newton
     iteration on the first, u_y = 0.1 at nodes 7 and 8) and
     examples/czm_instability.inp with formulation "total" (interface gap
     0.0999494, per-node interface force 0.0620504 of the Abaqus UEL log);
     then the snap-back state of tests/test_snapback.py (the 8 x 4 strip's
     interface opened past the traction peak, an indefinite tangent)
     through the matrix-free Newton, which must take the GMRES fallback,
     converge, and agree with the dense Newton and with the CPU run;
 12. fem_tpu's cohesive benchmark strip at full size (bench.py:650-659:
     360 x 72 x 2 quads, 360 cohesive elements, 105,412 DOFs, pulled to
     1.5 delta_n in 2 steps) through the matrix-free Newton-Krylov with the
     block stencil and lattice GMG: Newton and inner iterations, GMRES
     fallbacks, set-up and the inner / line-search / residual wall split, and
     the final Newton residual recomputed from assemble_csr's matrix and
     System.coh_force;
 13. the same strip node-permuted, through the fused operator and SA-AMG
     (K3 in its transfers), its u mapped back and held against phase 12's;
     then K3 against its plain version on every P, R and CSR mid-level
     table of that run's hierarchy (rebuilt by newton.matfree_operators);
 14. creep on the card: the Maxwell shear ramp of tests/test_viscoelastic.py
     (closed form to 3%, the CPU run to 1e-12); the 12^3 box with expn 3 on
     the direct and the structured MG-CG rows against the CPU (1e-9); then
     the 80^3 box (1,594,323 DOFs) with tau = 10 steps, 4 steps through
     structured_mg_cg with timing and a checkpoint each step: MG-CG
     iterations (12 +- 1 on step 1, no more on the warm-started steps 2-4),
     each step's true relative residual of
     F + f_creep recomputed with the per-corner form (<= 1e-8), the tip
     deflection against the elastic run's (larger by at least 3/4 of the
     12^3 box's increase on the CPU), a finite creep state, the phase
     timers, the peak device memory and the launches;
 15. that run resumed from its step-3 checkpoint, held against the
     uninterrupted run (u, stress and creep state to 1e-12), with each
     checkpoint's size and write time;
 16. one elastic step of the 80^3 box with timing and a torch.profiler
     trace, which must hold CUDA kernel events of K1 and K2;
 17. gradients through the kernels' autograd Functions, each backward a
     kernel: d<W, k_e>/d(lam, mu) at 131,072 elements against the plain
     form's autograd (1e-12); d<W, k_e>/dx there through K1's coordinate
     backward, float64 and float32, against the plain form's autograd and
     the plain contractions (1e-12 / 1e-5), the same bits twice, timed;
     through K2's: d<W, K u>/du on the 81^3 grid against the plain form's
     autograd (1e-12); the 6^3 box's compliance gradient in per-element E
     and in the node coordinates against the CPU (1e-10) and central
     differences (1e-5); K3's backward in x (K3 on the transposed table)
     and in data (csr_data_grad) on phase 9's level-0 P and R against the
     plain form's autograd (1e-12 / 1e-5), the same bits twice, timed
     beside cuSPARSE's SpMV and SDDMM; the gradient of <w, v_cycle(r)> in
     r and in P's data through phase 9's SA-AMG hierarchy against the same
     cycle on K3's plain form (1e-10) and against v_cycle(w);
 18. the native parser: the reference decks parse equal, field for field,
     to the Python parser's, and load(backend="native") equals
     load(backend="python") block by block; load(backend="auto") calls the
     native engine for each; the CLI with --parser native on the elastic
     golden deck; both parsers' host times on a 200,000-quad strip deck.

 19. CLI parity: the elastic golden deck through the CLI on cuda with
     --precond jacobi --solver cg --shards 2; the two shard files hold every
     element once, u_y 0.05 / 0.10, stress 105 / 245 / 0;
 20. the warm start at full width: the 80^3 box over 3 equal load steps
     through structured_mg_cg (step 1 takes 12 +- 1 iterations, steps 2-3
     no more; each step's true residual <= 1e-8);
 22. the element-sharded rows, FEM_TPU_TORCH_VIRTUAL_DEVICES=4 set here and
     4 shards on this one card (their wall says nothing about scaling):
     (a) ShardedOperator.matvec and diag against System.matvec / diag on the
     permuted 55^3 box (1e-12), one all-reduce of ndof * 8 bytes per K.u by
     commcount; (b) stepper.run(n_devices=4) through sharded_amg_cg on a
     deck where the halo-gather layout refuses (a node-permuted jittered
     plate of 2 x 100 x 100 cubic cells, 91,809 DOFs: three node planes
     along x, so an element reaches farther than a slab of the coordinate
     order), held against its own single-device run: iterations +-1, u to
     1e-9, true residual <= 1e-8, K3 launched; (c) the node-permuted
     cohesive strip with n_devices=4: phase 13's Newton counts, u to 1e-8;
 23. the slab-sharded stencil at 80^3, 4 shards: (a) matvec_sharded
     against structured.matvec (1e-12) with the scalar material and with a
     random per-cell field; one all-reduce of ndof * 8 bytes;
     K2 against both plain forms, as in phase 4, on every slab grid of the
     4- and the 3-shard run ((21, 81, 81); (28, 81, 81), (27, 81, 81)), and
     timed on one (21, 81, 81) slab beside cuSPARSE on the assembled matrix
     of the slab's own box; (b) stepper.run(n_devices=4) through
     sharded_slab_stencil against phase 7's run: 12 +- 1 iterations, u to
     1e-9, true residual <= 1e-8, K2's launches by grid; (c) the same with
     3 shards (80 cells: unequal slabs), and whether K2 ran on them;
 24. the halo block stencil on phase 10's lex 55^3 box: K.u against
     blockstencil.matvec (1e-12) with 4 and with 3 shards (56 node planes:
     unequal slabs), exactly two exchanges of 56 * 56 * 3 * 8 bytes;
     stepper.run(n_devices=4) through sharded_halo_block_stencil with
     lattice GMG: phase 10's iterations +-1, u to 1e-9, residual <= 1e-8,
     and the bytes that crossed shards per CG iteration;
 25. the halo-gather tier on phase 9's permuted 55^3 box: S and B of
     halo_gather.build, K.u against System.matvec (1e-12), exactly four
     exchanges of B * 3 * 8 bytes; stepper.run(n_devices=4) through
     sharded_amg_cg with SA-AMG on the slab-permuted matrix: total
     iterations <= 2 x phase 9's + 4, u to 1e-9, residual <= 1e-8, K1 and K3
     launched;
 26. one [comm] line per sharded tier: the collectives of one K.u;
 27. K2's 2D branch (the collapsed 9-point stencil, 2 DOFs a node) against
     the per-corner form and stencil9_plain, float64 (1e-12) and float32
     (1e-6), the same bits on a second call, on the (ny, nx) = (1025, 2049)
     node grid of phase 28's box, on (9, 7), (7, 9) and the degenerate
     (2, 2), (3, 2), (1, 4), (2, 9); its times on the box's grid beside its
     bound, stencil9_plain and cuSPARSE on the box's matrix (formed on the
     card from the tables, checked against the per-corner form);
 28. the clamped 2D cantilever meshgen.quad_grid_problem(2048, 1024, lx=2,
     ly=1) with a tip force (4,200,450 DOFs, float64) through stepper.run
     and structured_mg_cg: the true relative residual (per-corner form,
     <= 1e-8), MG-CG iterations, wall and phase timers, the 2D kernel's
     launches by MG level, no call of stencil_matvec_plain in the run;
     then the solve once more under torch.profiler: device time, kernels,
     stream synchronizations and host-to-device copies per CG iteration
     (the copies must be 0, and 0 in 20 fine K.u and 2 per-corner ones);
 29. the reference's make_example strip, meshgen.quad_strip_deck(4096,
     64) (532,610 DOFs), written to a deck and run through the CLI with
     --device cuda: path structured_mg_cg, the VTK written, true residual
     <= 1e-8; the strip cut to 256 x 16 through the CLI on cuda and on
     cpu, equal to 1e-9;
 30. the 2D slab-sharded row on phase 28's box, slabs along y, with
     FEM_TPU_TORCH_VIRTUAL_DEVICES=4: matvec_sharded against matvec
     (1e-12) with 4 and 3 shards, one 2D launch per slab; stepper.run with
     n_devices=4 and 3 through sharded_slab_stencil: phase 28's iterations
     +-1, u to 1e-9, residual <= 1e-8, the 2D kernel once per slab per fine
     K.u;
 31. plane stress on the stencil rows: phase 28's box with
     Config(plane_stress=True) through stepper.run and structured_mg_cg:
     MG-CG iterations, the 2D kernel's launches by MG level, no call of
     stencil_matvec_plain, and the true relative residual (<= 1e-8) with K
     applied by operator.build of the plane-stress System (the fused
     operator, which shares no code with the stencil); the stencil that
     structured.operator_for builds against that operator (1e-12), the
     residual the plane-strain stencil reads of the same u (> 1e-4: the
     check tells the two apart), the tip deflection beside phase 28's; the
     same box with n_devices=4 through sharded_slab_stencil: iterations
     +-1, u to 1e-9; the 3D decks of tests/test_3d_decks.py (a hex face
     traction, a tet point force, traction on a hex and a tet face at once;
     read from that file with ast) through stepper.run on cuda against cpu,
     direct and cg: the same path and iterations, u and stress to 1e-10
     (direct) and 1e-8 (Jacobi-CG, stopped at rtol 1e-9), K1 launched.
Each kernel's "launches" in the summary is the count of its main path's
run ("launches_path": the 80^3 elastic run for K1 and K2, phase 28's quad
box for K2's 2D branch, the 55^3 SA-AMG run for K3); "launches_by_path"
gives every counted run's own count.
A "[ t s] phase" line at each phase's start gives the seconds since the
script began.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}. Without CUDA, or without the package beside
it, the script exits non-zero before printing any result.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


T_START = time.perf_counter()


def stamp(phase):
    """One line with the seconds since the script began: where a run's time
    goes, phase by phase."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {phase}", flush=True)


@contextlib.contextmanager
def kept(module, name):
    """While open, every call of module.name also appends its result to the
    list this yields: what a run built (a hierarchy, an operator) is checked
    afterwards without building it a second time."""
    fn, results = getattr(module, name), []

    def keeping(*args, **kw):
        results.append(fn(*args, **kw))
        return results[-1]

    setattr(module, name, keeping)
    try:
        yield results
    finally:
        setattr(module, name, fn)


def time_back_to_back_ms(torch, fn, reps):
    """Mean CUDA-event time per call of reps calls issued back to back: the
    card's time per call where the host issues them faster than it runs
    them, else the host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(torch, fn, reps, flush=None):
    """Median CUDA-event time of fn() over reps calls, after one warm-up.
    With `flush` (a tensor several times the L2's 50 MB), the L2 is emptied
    by a read of it before each timed call: the cold time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s; FP64 34 TFLOP/s and FP32
# 67 TFLOP/s without the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


def bound(nbytes, flops, dtype_name):
    """(ms, kind): the least time of the work on the card, the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(torch, label, dtype_name, kernel, plain, library, nbytes, flops,
            flush, reps=50, plain_reps=10):
    """Times of a kernel against its bound, its plain version and a library
    call (None where no single PyTorch call computes the same function);
    prints them on one line and returns them."""
    b_ms, b_kind = bound(nbytes, flops, dtype_name)

    def three_ways(fn):
        return dict(ms=time_ms(torch, fn, reps),
                    back_to_back_ms=time_back_to_back_ms(torch, fn, reps),
                    cold_ms=time_ms(torch, fn, max(reps // 2, 5), flush))

    m = dict(three_ways(kernel), plain_ms=time_ms(torch, plain, plain_reps),
             bound_ms=b_ms, bound_by=b_kind)
    lib = {} if library is None else three_ways(library)
    for key in ("ms", "back_to_back_ms", "cold_ms"):
        m[f"library_{key}"] = lib.get(key)
    lib = ("none" if library is None else
           f"{m['library_ms']:.4f} (back to back "
           f"{m['library_back_to_back_ms']:.4f}, cold "
           f"{m['library_cold_ms']:.4f})")
    print(f"  {label} {dtype_name}: kernel {m['ms']:.4f} ms (back to back "
          f"{m['back_to_back_ms']:.4f}, cold {m['cold_ms']:.4f}), bound "
          f"{b_ms:.4f} ms by {b_kind} ({nbytes} bytes, {flops} flops; "
          f"{100 * b_ms / m['cold_ms']:.1f}% of it cold), plain "
          f"{m['plain_ms']:.4f} ms, library {lib} ms", flush=True)
    return m


def structured_box(torch, dev, problem):
    """(System, the stencil operator the stepper builds, rel(F, u)) of a
    structured box: rel is ||b - K u|| / ||b|| of the masked system with zero
    BC values and load F, K applied by the per-corner plain form, not K2."""
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import structured
    from fem_tpu_torch.solver import cg

    system = System(problem, torch.float64, device=dev)
    op = structured.operator_for(system, structured.detect(problem))
    k_ref = op.k_ref.contiguous()

    def plain_k(v):
        return ck.stencil_matvec_plain(k_ref, v, op.shape)

    mask = torch.zeros(problem.ndof, dtype=torch.bool, device=dev)
    mask[system.bc_dofs] = True

    def rel(F, u):
        b = cg.constrained_rhs(plain_k, F, mask, torch.zeros_like(u))
        r = b - cg.masked_operator(plain_k, mask)(u)
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    return system, op, rel


# the box material of phases 7 and 14: E = 200e9, nu = 0.3; creep with
# viscosity 10 G has the relaxation time tau = visc / G = 10 load steps
G_BOX = 200e9 / (2.0 * 1.3)


def creep_box(n, visc, expn, t=4.0):
    """meshgen's n^3 unit-cube cantilever (phase 7's box) with a creeping
    material and load steps of dt = 1 up to t."""
    from fem_tpu_torch.io import meshgen

    p = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0, E=200e9,
                                nu=0.3, tip_load=-1e6, t=t, dt=1.0)
    p.mats = p.mats.copy()
    p.mats[:, 2] = visc
    p.mats[:, 3] = expn
    return p


def shear_problem(E, nu, visc, gamma_total, t, dt):
    """tests/test_viscoelastic.py's unit square in pure shear: bottom edge
    fixed, top edge driven +x by gamma_total over [0, t], y pinned."""
    import numpy as np

    from fem_tpu_torch.models.problem import Block, Problem

    coords = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    bc_vals = np.array([[gamma_total if y == 1.0 else 0.0, 0.0]
                        for y in coords[:, 1]]).reshape(-1)
    return Problem(
        stype="implicit", pdim=2, t=t, dt=dt, coords=coords,
        blocks={"qua": Block("qua", conn=np.array([[0, 1, 2, 3]], np.int32),
                             mat=np.zeros(1, np.int32),
                             nlmat=np.full(1, -1, np.int32),
                             eids=np.zeros(1, np.int32))},
        mats=np.array([[E, nu, visc, 1.0, 0.0]]),
        coh_laws=np.zeros(0, np.int32), coh_props=np.zeros((0, 6)),
        bc_dofs=np.arange(8, dtype=np.int32), bc_vals=bc_vals,
        force_dofs=np.zeros((0, 2), np.int32), force_vec=np.zeros((0, 2)),
        force_t1=np.zeros(0), force_t2=np.zeros(0),
        trac_dofs=np.zeros((0, 2, 2), np.int32),
        trac_nodal_vec=np.zeros((0, 2)), trac_t1=np.zeros(0),
        trac_t2=np.zeros(0))


def rel_max(a, b):
    """max |a - b| / max |b| over numpy arrays or tensors."""
    import numpy as np

    a, b = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
            for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase14_creep(torch, dev, n_big, ck_dir):
    """Phase 14: creep on the card. Returns the 80^3 run's result, its
    per-step saves, its launches and its creep state at the last step."""
    import os

    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.solver import stepper
    from fem_tpu_torch.utils import checkpoint

    # 14.1 the Maxwell shear ramp (expn 1): closed form to 3%, CPU to 1e-12
    E, visc, gamma, T = 100.0, 20.0, 0.02, 2.0
    shear = shear_problem(E, 0.0, visc, gamma, T, 0.01)
    cfg = dict(viscoelastic=True, solver="direct", bc_mode="eliminate")
    r = {d: stepper.run(shear, Config(device=d, **cfg)) for d in ("cuda",
                                                                  "cpu")}
    G = E / 2.0
    exact = G * (gamma / T) * (visc / G) * (1.0 - np.exp(-T * G / visc))
    got = r["cuda"].aggregate_stress[0, 2]
    d_cpu = max(rel_max(r["cuda"].aggregate_stress,
                        r["cpu"].aggregate_stress),
                rel_max(r["cuda"].aggregate_u, r["cpu"].aggregate_u))
    print(f"creep: Maxwell shear ramp, {shear.nsteps} steps on cuda: "
          f"sigma_xy {got:.6f}, closed form {exact:.6f} "
          f"({100 * abs(got / exact - 1):.3f}% off, tol 3%), rel diff vs "
          f"CPU {d_cpu:.3e} (tol 1e-12)", flush=True)
    check(abs(got - exact) <= 0.03 * abs(exact), "Maxwell ramp off by > 3%")
    check(d_cpu <= 1e-12, f"Maxwell ramp cuda vs cpu: {d_cpu}")

    # 14.2 the 12^3 box, expn 3 (tau ~ 10 steps at 1e7 Pa), on the direct
    # and the structured MG-CG rows, on cuda against the CPU
    box12 = creep_box(12, 10.0 * G_BOX * 1e7 ** 2, 3.0)
    for solver, row in (("direct", "direct"), ("cg", "structured_mg_cg")):
        r = {d: stepper.run(box12, Config(device=d, viscoelastic=True,
                                          solver=solver))
             for d in ("cuda", "cpu")}
        d_u = rel_max(r["cuda"].aggregate_u, r["cpu"].aggregate_u)
        d_s = rel_max(r["cuda"].aggregate_stress, r["cpu"].aggregate_stress)
        print(f"creep: 12^3 box, expn 3, 4 steps, row {r['cuda'].path}: "
              f"iterations {r['cuda'].krylov_iters}, rel diff vs CPU u "
              f"{d_u:.3e}, stress {d_s:.3e} (tol 1e-9)", flush=True)
        check(r["cuda"].path == row, f"12^3 creep took {r['cuda'].path}")
        check(max(d_u, d_s) <= 1e-9, f"12^3 creep {row} cuda vs cpu")
    # the deflection margin of 14.3, from the 12^3 box with its material on
    # the CPU: the 80^3 box must creep by at least 3/4 of this increase
    box12 = creep_box(12, 10.0 * G_BOX, 1.0)
    tips = [stepper.run(box12, Config(device="cpu", viscoelastic=v))
            .aggregate_u.reshape(-1, 3)[:, 2].min() for v in (True, False)]
    ratio12 = tips[0] / tips[1]
    print(f"creep: 12^3 box, tau 10 steps, expn 1, on the CPU: tip "
          f"deflection {tips[0]:.6e} against elastic {tips[1]:.6e}, ratio "
          f"{ratio12:.6f}", flush=True)

    # 14.3 the 80^3 box through structured_mg_cg, checkpointing each step
    big = creep_box(n_big, 10.0 * G_BOX, 1.0)
    steps = []  # (F + f_creep, du) of each step
    saves = []  # (path, bytes, seconds) of each checkpoint
    save = checkpoint.save

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        saves.append((path, os.path.getsize(path), time.perf_counter() - t0))
        return path

    setup = recorded_steps(stepper, "structured_mg_cg", steps)
    checkpoint.save = timed_save
    msgs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        res = stepper.run(big, Config(device="cuda", viscoelastic=True,
                                      timing=True, checkpoint_dir=ck_dir),
                          log=msgs.append)
        torch.cuda.synchronize()
    finally:
        stepper._SETUP["structured_mg_cg"] = setup
        checkpoint.save = save
    wall = time.perf_counter() - t0
    launches = dict(ck.launches)
    peak = torch.cuda.max_memory_allocated()
    check(res.path == "structured_mg_cg", f"80^3 creep took {res.path}")
    # each step's true relative residual, with the per-corner form
    _, _, rel = structured_box(torch, dev, big)
    rels = [rel(F, du) for F, du in steps]
    del steps
    _, _, _, _, creep = checkpoint.load(os.path.join(ck_dir,
                                                     "state_000004.npz"))
    tm = res.timers
    elastic = stepper.run(big, Config(device="cuda"))
    tip, tip_el = (r.aggregate_u.reshape(-1, 3)[:, 2].min()
                   for r in (res, elastic))
    print(f"creep: {n_big}^3 box ({big.ndof} DOFs, float64, tau 10 steps, "
          f"expn 1), {res.nsteps} steps through {res.path}: MG-CG "
          f"iterations {res.krylov_iters}, true rel residuals "
          f"{['%.3e' % x for x in rels]}, tip deflection {tip:.6e} against "
          f"elastic {tip_el:.6e} (ratio {tip / tip_el:.6f}, 12^3: "
          f"{ratio12:.6f}), stepper.run wall {wall:.2f} s with checkpoints, "
          f"peak device memory {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated; {held / 2**30:.3f} GiB of it "
          f"held by earlier phases), launches {launches}",
          flush=True)
    print("creep: phase timers (synchronized):\n" + tm.report(), flush=True)
    print("creep: per step: " + ", ".join(
        f"{name} {1e3 * tm.totals[name] / tm.counts[name]:.2f} ms"
        for name in ("rhs", "solve", "stress")), flush=True)
    # each step starts from the last increment: step 1 is the cold count
    check(abs(res.krylov_iters[0] - 12) <= 1
          and all(0 < i <= res.krylov_iters[0] for i in res.krylov_iters[1:]),
          f"80^3 creep MG-CG iterations {res.krylov_iters}: step 1 not "
          f"12 +- 1, or a warm-started step took more")
    check(max(rels) <= 1e-8, f"80^3 creep true residuals {rels}")
    check(tip / tip_el - 1.0 >= 0.75 * (ratio12 - 1.0),
          f"80^3 creep deflection ratio {tip / tip_el} below the margin")
    check(set(creep) == {"hex"} and np.isfinite(creep["hex"]).all(),
          "80^3 creep state is not finite")
    check(np.isfinite(res.aggregate_stress).all(), "80^3 creep stress")
    for name in ("hex8_stiffness", "stencil_matvec"):
        check(launches[name] > 0, f"the 80^3 creep run launched no {name}")
    return res, saves, launches, creep


def phase15_resume(torch, big_n, ck_dir, res, saves, creep):
    """Phase 15: resume the 80^3 creep run from step 3; returns the resumed
    run's launches."""
    import os

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.solver import stepper
    from fem_tpu_torch.utils import checkpoint

    for path, size, seconds in saves:
        print(f"checkpoint {os.path.basename(path)}: {size} bytes, written "
              f"in {seconds:.3f} s ({size / seconds / 2**20:.1f} MiB/s)",
              flush=True)
    check(len(saves) == 4, f"{len(saves)} checkpoints, expected 4")
    os.unlink(os.path.join(ck_dir, "state_000004.npz"))
    msgs = []
    ck.reset_launches()
    t0 = time.perf_counter()
    again = stepper.run(creep_box(big_n, 10.0 * G_BOX, 1.0),
                        Config(device="cuda", viscoelastic=True,
                               checkpoint_dir=ck_dir), log=msgs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.launches)
    _, _, _, _, creep2 = checkpoint.load(os.path.join(ck_dir,
                                                      "state_000004.npz"))
    diffs = [rel_max(again.aggregate_u, res.aggregate_u),
             rel_max(again.aggregate_stress, res.aggregate_stress),
             rel_max(creep2["hex"], creep["hex"])]
    print(f"resume: {[m for m in msgs if 'Resumed' in m]}, MG-CG iterations "
          f"{again.krylov_iters}, wall {wall:.2f} s; rel diff against the "
          f"uninterrupted run: u {diffs[0]:.3e}, stress {diffs[1]:.3e}, creep "
          f"state {diffs[2]:.3e} (tol 1e-12), launches {launches}",
          flush=True)
    check(any("next interval 4" in m for m in msgs), "no resume from step 3")
    check(len(again.krylov_iters) == 1, "the resumed run ran more than 1 step")
    check(max(diffs) <= 1e-12, f"resumed run differs: {diffs}")
    return launches


def phase16_trace(torch, n_big):
    """Phase 16: one elastic step of the 80^3 box with timing and a
    torch.profiler trace that must hold K1's and K2's kernels."""
    import json
    import os

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.solver import stepper
    from fem_tpu_torch.utils.timing import TRACE_FILE

    box = meshgen.hex_box_problem(n_big, n_big, n_big, lx=1.0, ly=1.0,
                                  lz=1.0, E=200e9, nu=0.3, tip_load=-1e6)
    with tempfile.TemporaryDirectory() as tmp:
        msgs = []
        t0 = time.perf_counter()
        stepper.run(box, Config(device="cuda", timing=True, profile_dir=tmp),
                    log=msgs.append)
        wall = time.perf_counter() - t0
        path = os.path.join(tmp, TRACE_FILE)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    report = [m for m in msgs if m.startswith("Phase timers")]
    check(len(report) == 1, "the timed run printed no phase report")
    print(f"trace: {n_big}^3 elastic step, {report[0]}", flush=True)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    ours = {name: sum(name in k for k in kernels)
            for name in ("hex8_stiffness_kernel", "stencil27_kernel")}
    print(f"trace: {size} bytes of Chrome trace JSON, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events, by our kernels {ours}; "
          f"stepper.run with the profiler {wall:.2f} s", flush=True)
    for name, count in ours.items():
        check(count > 0, f"the trace holds no CUDA kernel event of {name}")


def phase17_gradients(torch, dev, k1_inputs, flush, amg55, mask55,
                      csr_library):
    """Phase 17: gradients through the autograd Functions of K1, K2 and K3,
    whose backward launches kernels only. amg55 is phase 9's kept
    FineAndHierarchy, mask55 its box's BC mask. Returns (the launches of
    each gradient run, each counted from 0 before its forward, keyed by
    run; the float64 measurements of the two backward kernels; those of
    K3's backward in x)."""
    import numpy as np

    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import elements, stiffness, structured
    from fem_tpu_torch.solver import amg, cg

    runs, summary = {}, {}
    x, lam, mu = k1_inputs(131072, torch.float64)
    W = torch.randn((24, 24, 131072), dtype=torch.float64, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    lam.requires_grad_()
    mu.requires_grad_()

    def grads(fn):
        return torch.autograd.grad((W * fn(x, lam, mu)).sum(), [lam, mu])

    ck.reset_launches()
    got = grads(ck.hex8_stiffness)
    torch.cuda.synchronize()
    launches = ck.launches["hex8_stiffness"]
    ref = grads(ck.hex8_stiffness_plain)
    errs = [rel_max(g, r) for g, r in zip(got, ref)]
    t_k1 = time_ms(torch, lambda: grads(ck.hex8_stiffness), 10)
    t_plain = time_ms(torch, lambda: grads(ck.hex8_stiffness_plain), 5)
    print(f"gradients: d<W, k_e>/d(lam, mu) at 131,072 hex8 through K1's "
          f"autograd Function ({launches} K1 launches: forward and two in "
          f"the backward), rel diff against the plain form's autograd "
          f"{errs[0]:.3e} / {errs[1]:.3e} (tol 1e-12); forward + backward "
          f"{t_k1:.4f} ms, plain {t_plain:.4f} ms", flush=True)
    check(launches == 3, f"K1 forward + backward launched {launches}")
    check(max(errs) <= 1e-12, f"K1 backward: {errs}")
    del W, got, ref, x, lam, mu

    # K1's backward in the coordinates, d<W, k_e>/dx, at phase 3's 131,072
    # elements: against the plain form's autograd and the plain contractions
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        x, lam, mu = k1_inputs(131072, dtype)
        W = torch.randn((24, 24, 131072), dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(2))
        xg = x.clone().requires_grad_()

        def autograd_x(fn):
            return torch.autograd.grad((W * fn(xg, lam, mu)).sum(), xg)[0]

        ck.reset_launches()
        got = autograd_x(ck.hex8_stiffness)
        torch.cuda.synchronize()
        n_k1 = dict(ck.launches)
        again = ck._hex8_coord_grad_launch(x, lam, mu, W)
        ref = autograd_x(ck.hex8_stiffness_plain)
        plain = ck.hex8_stiffness_coord_grad_plain(x, lam, mu, W)
        errs = rel_max(got, ref), rel_max(got, plain)
        print(f"gradients: d<W, k_e>/dx {name} at 131,072 hex8 through K1's "
              f"autograd Function (launches: K1 {n_k1['hex8_stiffness']}, "
              f"coordinate backward {n_k1['hex8_stiffness_coord_grad']}), "
              f"max rel diff against the plain form's autograd {errs[0]:.3e},"
              f" against the plain contractions {errs[1]:.3e} (tol "
              f"{tol:.0e})", flush=True)
        check(n_k1["hex8_stiffness"] == 1
              and n_k1["hex8_stiffness_coord_grad"] == 1,
              f"K1 coordinate gradient launched {n_k1}")
        check(torch.equal(got, again), f"K1 coordinate backward {name}: two "
              f"calls gave different bits")
        check(max(errs) <= tol, f"K1 coordinate backward {name}: {errs}")
        # least bytes: G (576 values), the coordinates, lam and mu read
        # once, the 24 gradients written; least operations: one FMA per G
        # entry and Gauss point, as the forward's
        isz = x.element_size()
        m = measure(torch, "K1 coordinate backward ne=131072", name,
                    lambda: ck._hex8_coord_grad_launch(x, lam, mu, W),
                    lambda: ck.hex8_stiffness_coord_grad_plain(x, lam, mu,
                                                               W),
                    None, (576 + 24 + 2 + 24) * 131072 * isz,
                    2 * 8 * 576 * 131072, flush, reps=20, plain_reps=5)
        t_auto = time_ms(torch, lambda: autograd_x(ck.hex8_stiffness_plain),
                         5)
        print(f"  K1 coordinate backward {name}: the plain form's autograd "
              f"(its forward and backward) {t_auto:.4f} ms", flush=True)
        if dtype == torch.float64:
            summary["hex8_stiffness_coord_grad"] = dict(
                m, max_abs_err=float((got - ref).abs().max()),
                plain_autograd_ms=t_auto)
        del x, lam, mu, W, xg, got, again, ref, plain

    # K2: d<W, K u>/du = K W on the 80^3 box's 81^3 node grid
    op = structured.build((1.0 / 80,) * 3, (81, 81, 81),
                          torch.tensor(1.5e11, dtype=torch.float64),
                          torch.tensor(7.7e10, dtype=torch.float64),
                          dtype=torch.float64, device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    u = torch.randn(op.ndof, dtype=torch.float64, device=dev, generator=gen,
                    requires_grad=True)
    W = torch.randn(op.ndof, dtype=torch.float64, device=dev, generator=gen)
    ck.reset_launches()
    (g_k2,) = torch.autograd.grad((W * ck.stencil_matvec(op.tables, u)).sum(),
                                  u)
    torch.cuda.synchronize()
    k2_launches = ck.launches["stencil_matvec"]
    (g_plain,) = torch.autograd.grad(
        (W * ck.stencil27_plain(op.tables, u)).sum(), u)
    err_k2 = rel_max(g_k2, g_plain)
    print(f"gradients: d<W, K u>/du on the 81^3 node grid through K2's "
          f"autograd Function ({k2_launches} K2 launches: forward and one in "
          f"the backward), rel diff against the plain form's autograd "
          f"{err_k2:.3e} (tol 1e-12)", flush=True)
    check(k2_launches == 2, f"K2 forward + backward launched {k2_launches}")
    check(err_k2 <= 1e-12, f"K2 backward: {err_k2}")
    runs["gradients"] = {"hex8_stiffness": launches,
                         "stencil_matvec": k2_launches}
    del op, u, W, g_k2, g_plain

    # compliance of the 6^3 box against per-element E and the node
    # coordinates
    box = meshgen.hex_box_problem(6, 6, 6, lx=1.0, ly=1.0, lz=1.0)
    et = elements.get("hex")

    def compliance_fn(device):
        conn = torch.as_tensor(box.blocks["hex"].conn, dtype=torch.int64,
                               device=device)
        coords0 = torch.as_tensor(box.coords, device=device)
        edofs = stiffness.element_dofs(et, conn)
        n = box.ndof
        F = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
            0, torch.as_tensor(box.force_dofs.reshape(-1), dtype=torch.int64,
                               device=device),
            torch.as_tensor(box.force_vec.reshape(-1), device=device))
        mask = torch.zeros(n, dtype=torch.bool, device=device)
        mask[torch.as_tensor(box.bc_dofs, dtype=torch.int64,
                             device=device)] = True

        def compliance(E_els, coords=coords0):
            lam_e, mu_e = stiffness.lame(E_els, torch.full_like(E_els, 0.3))
            ke = stiffness.element_stiffness_lame(et, coords[conn], lam_e,
                                                  mu_e)
            K = torch.zeros((n, n), dtype=torch.float64,
                            device=device).index_put(
                (edofs[:, :, None], edofs[:, None, :]), ke, accumulate=True)
            K = torch.where(mask[:, None] | mask[None, :], 0.0, K)
            K = K + torch.diag(mask.to(K.dtype))
            return F @ torch.linalg.solve(K, torch.where(mask, 0.0, F))

        return compliance, coords0

    ne = box.blocks["hex"].ne
    g, gx = {}, {}
    for device in ("cpu", dev):
        compliance, coords0 = compliance_fn(device)
        E0 = torch.full((ne,), 200e9, dtype=torch.float64, device=device,
                        requires_grad=True)
        (g[device],) = torch.autograd.grad(compliance(E0), E0)
        xc = coords0.clone().requires_grad_()
        ck.reset_launches()
        (gx[device],) = torch.autograd.grad(compliance(E0.detach(), xc), xc)
        torch.cuda.synchronize()
    runs["grad_coords_6"] = dict(ck.launches)
    d_cpu = rel_max(g[dev], g["cpu"])
    d_cpu_x = rel_max(gx[dev], gx["cpu"])
    rng = np.random.default_rng(0)
    fd_errs, fd_x_errs = [], []
    with torch.no_grad():
        E0 = torch.full((ne,), 200e9, dtype=torch.float64, device=dev)
        for e in rng.choice(ne, 3, replace=False):
            dE = torch.zeros_like(E0)
            dE[e] = 200e9 * 1e-4
            fd = (compliance(E0 + dE) - compliance(E0 - dE)) / (2 * dE[e])
            fd_errs.append(abs(float(g[dev][e]) / float(fd) - 1.0))
        # three coordinates of nodes that no BC pins, among those whose
        # gradient is at least a tenth of the largest; h = 1e-5 (the cells
        # are 1/6 wide)
        free = np.setdiff1d(np.arange(box.coords.shape[0]),
                            np.asarray(box.bc_dofs) // 3)
        gf = gx[dev][torch.as_tensor(free, device=dev)].abs().cpu().numpy()
        cand = np.argwhere(gf >= 0.1 * gf.max())
        picked = []
        for i, d in cand[rng.choice(len(cand), 3, replace=False)]:
            dx = torch.zeros_like(coords0)
            dx[free[i], d] = 1e-5
            fd = (compliance(E0, coords0 + dx)
                  - compliance(E0, coords0 - dx)) / 2e-5
            fd_x_errs.append(abs(float(gx[dev][free[i], d]) / float(fd)
                                 - 1.0))
            picked.append((int(free[i]), int(d)))
    print(f"gradients: d compliance / dE of the 6^3 box ({ne} elements) on "
          f"cuda: rel diff against the CPU plain autograd {d_cpu:.3e} (tol "
          f"1e-10), against central differences at 3 elements "
          f"{max(fd_errs):.3e} (tol 1e-5)", flush=True)
    print(f"gradients: d compliance / d coordinates of the 6^3 box on cuda "
          f"(launches {runs['grad_coords_6']}): rel diff against the CPU "
          f"plain autograd {d_cpu_x:.3e} (tol 1e-10), against central "
          f"differences at (node, axis) {picked} "
          f"{['%.3e' % e for e in fd_x_errs]} (tol 1e-5)", flush=True)
    check(d_cpu <= 1e-10, f"compliance gradient cuda vs cpu: {d_cpu}")
    check(max(fd_errs) <= 1e-5, f"compliance gradient vs FD: {fd_errs}")
    check(runs["grad_coords_6"]["hex8_stiffness_coord_grad"] == 1,
          "the coordinate gradient launched no K1 coordinate backward")
    check(d_cpu_x <= 1e-10, f"coordinate gradient cuda vs cpu: {d_cpu_x}")
    check(max(fd_x_errs) <= 1e-5, f"coordinate gradient vs FD: {fd_x_errs}")

    # K3's backward in x and data on the 55^3 level-0 P and R, against the
    # plain form's autograd; P and R are each other's transposed table
    lv0 = amg55.hier.levels[0]
    P32 = dataclasses.replace(lv0.P, data=lv0.P.data.float())
    R32 = dataclasses.replace(lv0.R, data=lv0.R.data.float())
    amg.link_transposes(P32, R32)
    x_bar = {}
    for dtype, tol, tables in ((torch.float64, 1e-12, (lv0.P, lv0.R)),
                               (torch.float32, 1e-5, (P32, R32))):
        dname = str(dtype).split(".")[-1]
        for label, t in zip(("P", "R"), tables):
            n, ncols = t.shape
            nnz, isz = t.data.shape[0], t.data.element_size()
            gen = torch.Generator(dev).manual_seed(3)
            x = torch.randn(ncols, dtype=dtype, device=dev, generator=gen,
                            requires_grad=True)
            gy = torch.randn(n, dtype=dtype, device=dev, generator=gen)
            # a view of the table's data that requires grad
            data = t.data.detach().requires_grad_()

            def k3_grads():
                out = ck.csr_matvec(t.indptr, t.indices, data, x, t.lanes,
                                    t.transposed)
                return torch.autograd.grad(out, [x, data], gy)

            ck.reset_launches()
            got = k3_grads()
            torch.cuda.synchronize()
            n_k3 = dict(ck.launches)
            again = k3_grads()
            ref = torch.autograd.grad(ck.csr_matvec_plain(
                t.indptr, t.indices, data, x), [x, data], gy)
            errs = [rel_max(a, b) for a, b in zip(got, ref)]
            print(f"gradients: K3's backward {dname} on the 55^3 level-0 "
                  f"{label} ({n} x {ncols}, {nnz} nonzeros; launches "
                  f"{n_k3['csr_matvec']} K3, {n_k3['csr_data_grad']} "
                  f"csr_data_grad): max rel diff against the plain form's "
                  f"autograd in x {errs[0]:.3e}, in data {errs[1]:.3e} (tol "
                  f"{tol:.0e})", flush=True)
            check(n_k3["csr_matvec"] == 2 and n_k3["csr_data_grad"] == 1,
                  f"K3 backward on {label} launched {n_k3}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K3 backward {dname} {label}: two calls gave different "
                  f"bits")
            check(max(errs) <= tol, f"K3 backward {dname} {label}: {errs}")
            # x's backward: K3 on the transposed table (R for P, P for R),
            # beside cuSPARSE's SpMV on the same transposed CSR; least
            # bytes as K3's
            tt = t.transposed()
            lib_t = csr_library(tt.indptr, tt.indices, tt.data, tt.shape)
            m_x = measure(
                torch, f"K3 backward in x ({label}^T, {tt.shape[0]} rows)",
                dname,
                lambda: ck._k3_launch(tt.indptr, tt.indices, tt.data, gy,
                                      tt.lanes),
                lambda: ck.csr_matvec_plain(tt.indptr, tt.indices, tt.data,
                                            gy),
                lambda: lib_t(gy), nnz * (isz + 4) + (n + ncols) * isz,
                2 * nnz, flush)
            # data's backward, beside cuSPARSE's SDDMM (sampled_addmm) on
            # the same pattern where it runs in this dtype; least bytes:
            # each nonzero's column read and its product written, x and gy
            # read
            xd = x.detach()
            lib_d = sddmm_library(torch, t, xd, gy, got[1])
            m_d = measure(
                torch, f"K3 backward in data ({label})", dname,
                lambda: ck._csr_data_grad_launch(t.indptr, t.indices, xd, gy,
                                                 t.lanes),
                lambda: ck.csr_data_grad_plain(t.indptr, t.indices, xd, gy),
                lib_d, nnz * (4 + isz) + (n + ncols) * isz, nnz, flush,
                reps=20)
            if dtype == torch.float64:
                x_bar[label] = dict(m_x, max_abs_err=float(
                    (got[0] - ref[0]).abs().max()))
                if label == "P":
                    summary["csr_data_grad"] = dict(m_d, max_abs_err=float(
                        (got[1] - ref[1]).abs().max()))
            del x, gy, data, got, again, ref
    del P32, R32

    # the gradient of <w, v_cycle(r)> in r and in level 0's P data, through
    # the 55^3 SA-AMG hierarchy with the stepper's masked fine operator,
    # against the same cycle with every table applied by K3's plain form
    h = amg55.hier
    P = dataclasses.replace(lv0.P, data=lv0.P.data.detach().requires_grad_())
    amg.link_transposes(P, lv0.R)
    h = dataclasses.replace(h, levels=(dataclasses.replace(lv0, P=P),)
                            + h.levels[1:])
    mv = cg.masked_operator(amg55.fine, mask55)
    gen = torch.Generator(dev).manual_seed(4)
    r = torch.randn(mask55.shape[0], dtype=torch.float64, device=dev,
                    generator=gen, requires_grad=True)
    w = torch.randn(mask55.shape[0], dtype=torch.float64, device=dev,
                    generator=gen)

    def cycle_grads():
        return torch.autograd.grad((w * amg.v_cycle(h, mv, r)).sum(),
                                   [r, P.data])

    ck.reset_launches()
    got, wall = sync_wall(torch, cycle_grads)
    runs["grad_vcycle_55"] = dict(ck.launches)
    free = ~mask55

    def by_part(a, b):
        """rel_max over the free DOFs and over the constrained ones: the
        masked operator's identity rows make the constrained entries of the
        r gradient O(1) and the free ones, the only ones the transfers
        reach, O(1 / (E h)); one maximum over all would not see them."""
        return [rel_max(a[free], b[free]), rel_max(a[mask55], b[mask55])]

    with torch.no_grad():
        sym = by_part(got[0], amg.v_cycle(h, mv, w))
    wall_fwd = sync_wall(torch, lambda: amg.v_cycle(h, mv, r.detach()))[1]
    k3 = ck.csr_matvec
    ck.csr_matvec = (lambda indptr, indices, data, x, lanes, transpose:
                     ck.csr_matvec_plain(indptr, indices, data, x))
    try:
        ref, wall_plain = sync_wall(torch, cycle_grads)
    finally:
        ck.csr_matvec = k3
    errs = by_part(got[0], ref[0]) + [rel_max(got[1], ref[1])]
    print(f"gradients: d<w, v_cycle(r)>/d(r, P data) through the 55^3 SA-AMG "
          f"hierarchy ({len(h.levels)} levels) on cuda, launches "
          f"{runs['grad_vcycle_55']}: max rel diff against the cycle with "
          f"K3's plain form in r over the free DOFs {errs[0]:.3e} (max "
          f"|grad| there {float(ref[0][free].abs().max()):.3e}), over the "
          f"constrained ones {errs[1]:.3e} (max |grad| "
          f"{float(ref[0][mask55].abs().max()):.3e}), in P's data "
          f"{errs[2]:.3e} (tol 1e-10); against v_cycle(w) (the cycle is "
          f"symmetric) free {sym[0]:.3e}, constrained {sym[1]:.3e} (tol "
          f"1e-8); wall (synchronized) {wall * 1e3:.1f} ms, forward alone "
          f"{wall_fwd * 1e3:.1f} ms, plain K3 {wall_plain * 1e3:.1f} ms",
          flush=True)
    check(max(errs) <= 1e-10, f"V-cycle gradient against plain K3: {errs}")
    check(max(sym) <= 1e-8, f"V-cycle gradient against v_cycle(w): {sym}")
    for name in ("csr_matvec", "csr_data_grad"):
        check(runs["grad_vcycle_55"][name] > 0,
              f"the V-cycle gradient launched no {name}")
    return runs, summary, x_bar


def sddmm_library(torch, t, x, gy, expect):
    """The yardstick of K3's backward in data: cuSPARSE's SDDMM through
    torch.sparse.sampled_addmm on t's pattern (int32 indices), checked
    against `expect`; None where it does not run in this dtype. The port
    never calls it."""
    A = torch.sparse_csr_tensor(t.indptr.to(torch.int32), t.indices,
                                torch.zeros_like(t.data), size=t.shape,
                                check_invariants=False)
    g2, x2 = gy[:, None], x[None, :]

    def sddmm():
        return torch.sparse.sampled_addmm(A, g2, x2, beta=0.0)

    try:
        got = sddmm().values()
    except RuntimeError as e:
        print(f"  sampled_addmm does not run in {t.data.dtype}: "
              f"{str(e).splitlines()[0]}", flush=True)
        return None
    err = rel_max(got, expect)
    tol = 1e-12 if t.data.dtype == torch.float64 else 1e-5
    check(err <= tol, f"sampled_addmm against K3's backward in data: {err}")
    return sddmm


def recorded_steps(stepper, row, steps):
    """stepper._SETUP[row] wrapped so that every step's (F, du) is appended
    to `steps`; returns the original set-up, to be put back."""
    setup = stepper._SETUP[row]

    def recording_setup(*args):
        step = setup(*args)

        def recorded(F, du_prev, aggregate_u, t_end):
            inc = step(F, du_prev, aggregate_u, t_end)
            steps.append((F, inc.du))
            return inc

        return recorded

    stepper._SETUP[row] = recording_setup
    return setup


def sync_wall(torch, fn):
    """(fn(), host seconds) with the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tally_k2(ck, key):
    """Count K2's calls by key(tables, u) around the wrapper; returns the
    tally and a function that puts the wrapper back."""
    tally = {}
    wrapper = ck.stencil_matvec

    def counted(t, u):
        k = key(t, u)
        tally[k] = tally.get(k, 0) + 1
        return wrapper(t, u)

    ck.stencil_matvec = counted

    def restore():
        ck.stencil_matvec = wrapper

    return tally, restore


def phase19_cli_shards(cli_main, vtk):
    """Phase 19: --precond / --shards through the CLI on the card."""
    import numpy as np

    deck = "examples/ref/SNES_test/elastic/elastic_test.inp"
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli_main(["-f", deck, "--device", "cuda", "-q", "--precond",
                       "jacobi", "--solver", "cg", "--shards", "2",
                       "-o", f"{tmp}/"])
        check(rc == 0, f"CLI --shards 2 exited {rc}")
        cells = 0
        for rank in range(2):
            path = f"{tmp}/{rank}_output_000000.vtk"
            pts, stress, disp = vtk.read_fields(path)
            with open(path) as f:
                cells += sum(1 for line in f if line.startswith("4 "))
            for y, uy in ((2.0, 0.1), (1.0, 0.05), (0.0, 0.0)):
                rows = pts[:, 1] == y
                check(np.allclose(disp[rows, 1], uy, atol=1e-9),
                      f"shard {rank} u_y at y={y}: {disp[rows, 1]}")
            check(np.allclose(stress[:, :2], [105.0, 245.0], atol=1e-5)
                  and np.allclose(stress[:, 2], 0.0, atol=1e-5),
                  f"shard {rank} stress: {stress}")
    check(cells == 2, f"the shard files hold {cells} elements, not 2")
    print("CLI --precond jacobi --solver cg --shards 2 on cuda: 2 shard "
          "files, every element once, u_y 0.05/0.10, stress 105/245/0 ok",
          flush=True)


def phase20_warm(torch, dev, n):
    """Phase 20: the warm-started 3-step 80^3 run. Returns its launches."""
    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.solver import stepper

    box3 = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0, E=200e9,
                                   nu=0.3, tip_load=-1e6, t=3.0, dt=1.0)
    steps = []
    setup = recorded_steps(stepper, "structured_mg_cg", steps)
    ck.reset_launches()
    try:
        res, wall = sync_wall(torch, lambda: stepper.run(
            box3, Config(device="cuda")))
    finally:
        stepper._SETUP["structured_mg_cg"] = setup
    launches = dict(ck.launches)
    _, _, rel = structured_box(torch, dev, box3)
    rels = [rel(F, du) for F, du in steps]
    del steps
    print(f"warm start: {n}^3 box ({box3.ndof} DOFs, float64), 3 equal load "
          f"steps through {res.path}: MG-CG iterations {res.krylov_iters}, "
          f"true rel residuals {['%.3e' % x for x in rels]}, stepper.run "
          f"wall {wall:.2f} s, launches {launches}", flush=True)
    its = res.krylov_iters
    check(res.path == "structured_mg_cg", f"3-step box took {res.path}")
    check(len(its) == 3 and abs(its[0] - 12) <= 1
          and all(i <= its[0] for i in its[1:]),
          f"3-step box MG-CG iterations {its}: step 1 not 12 +- 1, or a "
          f"warm-started step took more")
    check(max(rels) <= 1e-8, f"3-step box true residuals {rels}")

    return launches


def traced_run(torch, stepper, problem, config):
    """stepper.run with its log lines printed, its wall between
    synchronizations, and its collectives: (result, wall, log lines, all
    collectives, those issued once the load steps had begun)."""
    from fem_tpu_torch.parallel import mesh as mesh_mod

    rec, msgs, marks = [], [], []

    def log(m):
        msgs.append(m)
        if "Interval" in m:
            marks.append(len(rec))

    mesh_mod.recorders.append(rec)
    try:
        res, wall = sync_wall(torch, lambda: stepper.run(problem, config,
                                                         log=log))
    finally:
        mesh_mod.recorders.remove(rec)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    return res, wall, msgs, rec, rec[marks[0]:]


def phase22_sharded(torch, dev, perm55, pstrip, res13, true_rel_residual):
    """Phase 22: the element-sharded rows, 4 shards on this one card.
    Returns the launches of the sharded SA-AMG run and the sharded strip,
    the collectives of one element-sharded K.u, and the permuted 55^3 box's
    System."""
    import os

    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import operator
    from fem_tpu_torch.parallel import commcount
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.parallel.ops import ShardedOperator
    from fem_tpu_torch.solver import amg, stepper

    # in the open: more shards than cards, laid round-robin over the cards
    os.environ[mesh_mod.VIRTUAL_ENV] = "4"
    mesh = mesh_mod.make_mesh(4, device="cuda")
    label = mesh.describe()
    print(f"sharded: {mesh_mod.VIRTUAL_ENV}=4, {label}", flush=True)
    check(mesh.size == 4, f"the mesh has {mesh.size} shards")

    # (a) the operator; phase 25 shards the same System (built here, not
    # kept from phase 9, so that phase 14's peak memory is the creep run's)
    sys_perm = system = System(perm55, torch.float64, device=dev)
    sop = ShardedOperator(system, mesh)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        system.ndof), device=dev)
    ref = system.matvec(u)
    got = sop.matvec(u)
    e_mv = float((got - ref).abs().max() / ref.abs().max())
    d_ref = system.diag()
    e_dg = float((sop.diag() - d_ref).abs().max() / d_ref.abs().max())
    cols = comm_kmv = commcount.collectives(sop.matvec, u)
    ar = [c for c in cols if c[0] == "all_reduce_sum"]
    fop = operator.build(system)
    t_shd = time_ms(torch, lambda: sop.matvec(u), 20)
    t_one = time_ms(torch, lambda: operator.matvec(fop, u), 20)
    print(f"sharded K.u on the permuted 55^3 box ({system.ndof} DOFs): rel "
          f"diff vs System.matvec {e_mv:.3e}, diag {e_dg:.3e} (tol 1e-12); "
          f"{label}: {t_shd:.4f} ms per K.u against the fused operator's "
          f"{t_one:.4f} ms on the card alone (no scaling statement)",
          flush=True)
    check(e_mv <= 1e-12 and e_dg <= 1e-12,
          f"sharded operator differs: matvec {e_mv}, diag {e_dg}")
    check(len(ar) == 1 and ar[0][1] == (system.ndof,)
          and ar[0][2] == system.ndof * 8,
          f"sharded K.u collectives: {cols}")
    del sop, fop, ref, got, d_ref

    # (b) the sharded SA-AMG row, on a deck that the halo-gather layout
    # refuses: 3 node planes along x, 4 slabs of the coordinate order
    plate = meshgen.permute_nodes(meshgen.hex_box_problem(
        2, 100, 100, lx=2.0 / 100, ly=1.0, lz=1.0, E=200e9, nu=0.3,
        tip_load=-1e6, jitter=0.25, seed=0), seed=0)
    ref = stepper.run(plate, Config(device="cuda"))
    ck.reset_launches()
    res, wall, msgs, cols, _ = traced_run(
        torch, stepper, plate, Config(device="cuda", n_devices=4))
    launches_amg = dict(ck.launches)
    ar = [c[2] for c in cols if c[0] == "all_reduce_sum"]
    n_ar, b_ar = len(ar), sum(ar)
    rel_u = rel_max(res.aggregate_u, ref.aggregate_u)
    system = System(plate, torch.float64, device=dev)
    true_rel = true_rel_residual(
        system, amg.assemble_csr(system),
        torch.as_tensor(res.aggregate_u, device=dev))
    print(f"sharded SA-AMG, permuted 2 x 100 x 100 plate ({plate.ndof} DOFs)"
          f", {label}: path {res.path}, iterations {res.krylov_iters} "
          f"(single device {ref.krylov_iters}), max |du| / max |u| vs the "
          f"single-device run {rel_u:.3e} (tol 1e-9), true rel residual "
          f"{true_rel:.3e}, {n_ar} all-reduces of {b_ar // n_ar} bytes, "
          f"stepper.run wall {wall:.2f} s, launches {launches_amg}",
          flush=True)
    check(res.path == "sharded_amg_cg"
          and ref.path == "unstructured_amg_or_lattice_gmg_cg",
          f"the plate took {res.path} and {ref.path}")
    check(any("halo-gather layout unavailable" in m for m in msgs)
          and any("element-sharded tier" in m for m in msgs),
          "the plate did not fall back to the element-sharded tier")
    check(len(res.krylov_iters) == len(ref.krylov_iters)
          and all(abs(a - b) <= 1 for a, b in zip(res.krylov_iters,
                                                  ref.krylov_iters)),
          f"sharded iterations {res.krylov_iters} vs {ref.krylov_iters}")
    check(rel_u <= 1e-9, f"sharded plate u differs by {rel_u}")
    check(true_rel <= 1e-8, f"sharded plate true rel residual {true_rel}")
    check(launches_amg["csr_matvec"] > 0 and launches_amg["hex8_stiffness"]
          > 0, "the sharded SA-AMG run launched no K3 or no K1")
    check(b_ar == n_ar * system.ndof * 8, "an all-reduce of another size")
    del system

    # (c) the sharded matrix-free Newton
    ck.reset_launches()
    res, wall, msgs, cols, _ = traced_run(
        torch, stepper, pstrip,
        Config(device="cuda", solver="cg", n_devices=4))
    launches_coh = dict(ck.launches)
    rel_u = float(np.abs(res.aggregate_u - res13.aggregate_u).max()
                  / np.abs(res13.aggregate_u).max())
    print(f"sharded Newton, permuted cohesive strip ({pstrip.ndof} DOFs), "
          f"{label}: Newton iterations {res.newton_iters} (single device "
          f"{res13.newton_iters}), inner {res.krylov_iters} "
          f"({res13.krylov_iters}), GMRES fallbacks {res.gmres_fallbacks}, "
          f"max |du| / max |u| {rel_u:.3e} (tol 1e-8), "
          f"{sum(c[0] == 'all_reduce_sum' for c in cols)} all-reduces, "
          f"stepper.run wall {wall:.2f} s, launches {launches_coh}",
          flush=True)
    check(any("Nonlinear path" in m for m in msgs)
          and any("element-sharded" in m for m in msgs),
          "the strip's elastic operator was not sharded")
    check(all(res.newton_converged)
          and res.newton_iters == res13.newton_iters,
          f"sharded Newton iterations {res.newton_iters} vs "
          f"{res13.newton_iters}")
    check(all(abs(a - b) <= 2 for a, b in zip(res.krylov_iters,
                                              res13.krylov_iters)),
          f"sharded inner iterations {res.krylov_iters} vs "
          f"{res13.krylov_iters}")
    check(rel_u <= 1e-8, f"sharded strip u differs by {rel_u}")
    check(launches_coh["csr_matvec"] > 0, "the sharded Newton launched no K3")
    return launches_amg, launches_coh, comm_kmv, sys_perm


def check_run(res, ref, path, rel_u, true_rel, label):
    """A sharded run's path, u against the single-device run's (1e-9), true
    relative residual (<= 1e-8) and finite stress."""
    import numpy as np

    check(res.path == path, f"{label} took {res.path}, not {path}")
    check(rel_u <= 1e-9, f"{label}: u differs from the single-device run's "
                         f"by {rel_u}")
    check(true_rel <= 1e-8, f"{label}: true rel residual {true_rel}")
    check(res.aggregate_stress.shape == ref.aggregate_stress.shape
          and bool(np.isfinite(res.aggregate_stress).all()),
          f"{label}: stress not finite or of the wrong shape")


def phase23_slab(torch, dev, big, res7, k2_case, k2_measure):
    """Phase 23: the slab-sharded stencil at 80^3. k2_case and k2_measure
    are phase 4's checks of K2 on an operator's grid. Returns the launches of
    the 4- and 3-shard runs, K2's measurements on one slab, and the
    collectives of one sharded K.u."""
    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import structured
    from fem_tpu_torch.parallel import commcount
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.solver import amg, stepper

    mesh = mesh_mod.make_mesh(4, device="cuda")
    label = mesh.describe()
    system, op, rel = structured_box(torch, dev, big)
    n, nn = op.ndof, op.shape[0]  # DOFs; nodes a side (81)
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.standard_normal(n), device=dev)
    cells = tuple(c - 1 for c in op.shape)
    field_op = structured.StencilOperator(
        op.k_lam, op.k_mu,
        op.lam * torch.as_tensor(rng.uniform(0.5, 1.5, cells), device=dev),
        op.mu * torch.as_tensor(rng.uniform(0.5, 1.5, cells), device=dev),
        op.shape)
    # (a) the two sharded forms against the single-device K.u
    for name, o in (("scalar material", op), ("per-cell field", field_op)):
        sl = structured.shard_slabs(o, mesh)
        ref = structured.matvec(o, u)
        errs = {}
        ck.reset_launches()
        comm_psum = commcount.collectives(
            lambda: errs.update(psum=rel_max(structured.matvec_sharded(sl, u),
                                             ref)))
        k2 = ck.launches["stencil_matvec"]
        print(f"slab stencil {nn - 1}^3 ({n} DOFs), {name}, {label}: "
              f"matvec_sharded rel diff {errs['psum']:.3e} (tol 1e-12), K2 "
              f"launches of the apply {k2}", flush=True)
        check(max(errs.values()) <= 1e-12, f"slab K.u ({name}): {errs}")
        check(k2 == (4 if o is op else 0),
              f"slab K.u ({name}) launched K2 {k2} times")
        check(sorted(comm_psum) == [("all_reduce_sum", (n,), n * 8),
                                    ("replicate", (n,), n * 8)],
              f"matvec_sharded collectives: {comm_psum}")
        if o is op:
            lop = sl.ops[0]
    del field_op, sl, ref
    # K2 against both plain forms on every slab grid that the 4- and the
    # 3-shard runs below give it, in float64 and float32 as in phase 4
    slab_err = {}
    for shards in (4, 3):
        slabs = structured.shard_slabs(
            op, mesh_mod.make_mesh(shards, device="cuda"))
        for o in slabs.ops:
            if o.shape not in slab_err:
                slab_err[o.shape] = k2_case(o)
    want = {(e - s + 1, nn, nn) for shards in (4, 3)
            for s, e in mesh_mod.slab_bounds(nn - 1, shards)}
    check(set(slab_err) == want and lop.shape in want,
          f"K2 was held on slab grids {sorted(slab_err)}, not {sorted(want)}")
    del slabs
    # K2's times on one slab of the 4-shard run beside cuSPARSE on the
    # assembled matrix of the slab's own box
    nc = lop.shape[0] - 1
    slab_box = meshgen.hex_box_problem(
        nc, nn - 1, nn - 1, lx=nc / (nn - 1), ly=1.0, lz=1.0,
        E=200e9, nu=0.3)
    m_slab = dict(
        k2_measure(lop, amg.assemble_csr(System(slab_box, torch.float64,
                                                device=dev))),
        max_abs_err=slab_err[lop.shape], shape=list(lop.shape))

    # (b), (c) the stepper row with 4 shards and with 3
    F = system.rhs(0.0)
    launches = {}
    for shards in (4, 3):
        k2_by_grid, restore_k2 = tally_k2(ck, lambda t, u: t.shape)
        ck.reset_launches()
        try:
            res, wall, msgs, cols, solve = traced_run(
                torch, stepper, big, Config(device="cuda", n_devices=shards))
        finally:
            restore_k2()
        launches[shards] = dict(ck.launches)
        rel_u = rel_max(res.aggregate_u, res7.aggregate_u)
        true_rel = rel(F, torch.as_tensor(res.aggregate_u, device=dev))
        ar = [c[2] for c in solve if c[0] == "all_reduce_sum"]
        on_slabs = {g: k for g, k in k2_by_grid.items()
                    if g[0] < nn and g[1:] == (nn, nn)}
        print(f"sharded slab stencil, {nn - 1}^3 box, {shards} shards on 1 "
              f"card: "
              f"path {res.path}, MG-CG iterations {res.krylov_iters} (single "
              f"device {res7.krylov_iters}), max |du| / max |u| {rel_u:.3e} "
              f"(tol 1e-9), true rel residual {true_rel:.3e}, {len(ar)} "
              f"all-reduces of {n * 8} bytes in the solve, stepper.run wall "
              f"{wall:.2f} s (no scaling statement), K2 launches "
              f"{launches[shards]['stencil_matvec']}, by grid {k2_by_grid}: "
              f"{sum(on_slabs.values())} on slab grids (the fine level ran "
              f"on {'K2' if on_slabs else 'the cell form'})", flush=True)
        check_run(res, res7, "sharded_slab_stencil", rel_u, true_rel,
                  f"{nn - 1}^3 box, {shards} shards")
        check(any("MG fine level sharded over the slab mesh" in m
                  for m in msgs), "the MG fine level was not sharded")
        check(all(abs(i - j) <= 1 for i, j in zip(res.krylov_iters,
                                                  res7.krylov_iters)),
              f"sharded MG-CG iterations {res.krylov_iters} against "
              f"{res7.krylov_iters}")
        check(set(ar) == {n * 8}, "an all-reduce of another size")
        slab_grids = {(e - s + 1, nn, nn) for s, e in
                      mesh_mod.slab_bounds(nn - 1, shards)}
        check(set(on_slabs) >= slab_grids and len(ar) * shards
              == sum(k for g, k in on_slabs.items() if g in slab_grids),
              f"K2 did not run once per shard per fine K.u: {k2_by_grid}")
    return launches[4], launches[3], m_slab, comm_psum


def phase24_halo_block(torch, dev, lex, res10, A_lex, true_rel_residual):
    """Phase 24: the halo block stencil on the lex 55^3 box. Returns the
    launches of the sharded run and the collectives of one K.u."""
    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import blockstencil as bs
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.parallel import commcount
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.solver import stepper

    # the run first; its block stencil operator, kept, is the one that the
    # sharded K.u is held against below
    ck.reset_launches()
    with kept(bs, "build") as built:
        res, wall, msgs, cols, solve = traced_run(
            torch, stepper, lex, Config(device="cuda", n_devices=4))
    launches = dict(ck.launches)
    # the first one built is the fine operator (lattice GMG builds its
    # coarse levels' after it)
    check(len(built) >= 1, "the run built no block stencil")
    bop = built[0]
    del built[:]
    system = System(lex, torch.float64, device=dev)
    dims = bop.dims
    check(len(set(dims)) == 1 and system.nnds == bop.nnds,
          f"the lex box's lattice is {dims}")
    plane = dims[1] * dims[2] * 3 * 8
    rel_u = rel_max(res.aggregate_u, res10.aggregate_u)
    true_rel = true_rel_residual(system, A_lex, torch.as_tensor(
        res.aggregate_u, device=dev))
    its = sum(res.krylov_iters)
    crossed = sum(c[2] for c in solve)
    print(f"sharded halo block stencil, lex 55^3 box, 4 shards on 1 card: "
          f"path {res.path}, GMG-CG iterations {res.krylov_iters} (single "
          f"device {res10.krylov_iters}), max |du| / max |u| {rel_u:.3e} "
          f"(tol 1e-9), true rel residual {true_rel:.3e}, stepper.run wall "
          f"{wall:.2f} s (no scaling statement), launches {launches}",
          flush=True)
    print("  " + commcount.summary("the solve", solve)
          + f": {crossed // its} bytes crossed shards per CG iteration "
          f"({crossed} in {its}), against {system.ndof * 8} per K.u and as "
          f"many per replicated input on the element-sharded tier",
          flush=True)
    check_run(res, res10, "sharded_halo_block_stencil", rel_u, true_rel,
              "lex 55^3 box, 4 shards")
    check(any("Geometric lattice-MG" in m for m in msgs)
          and not any("demotion" in m for m in msgs),
          "the sharded lex box did not solve with lattice GMG")
    check(len(res.krylov_iters) == len(res10.krylov_iters) and all(
        abs(a - b) <= 1 for a, b in zip(res.krylov_iters,
                                        res10.krylov_iters)),
          f"sharded GMG-CG iterations {res.krylov_iters} vs "
          f"{res10.krylov_iters}")
    check({c[2] for c in solve if c[0] == "neighbor_exchange"} == {plane}
          and {c[2] for c in solve if c[0] == "all_reduce_sum"} == {8},
          "the solve moved more than planes between neighbours or "
          "all-reduced more than scalars")
    check(launches["hex8_stiffness"] > 0, "the sharded GMG run launched no K1")
    # one K.u with 4 and with 3 shards against the single-device form
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        system.ndof), device=dev)
    ref = bs.matvec(bop, u)
    for shards in (4, 3):
        mesh = mesh_mod.make_mesh(shards, device="cuda")
        hop = bs.shard_rows(bop, mesh)
        lay = hop.layout()
        us = lay.scatter(u)
        out = {}
        comm = commcount.collectives(lambda: out.update(
            f=bs.halo_matvec_g(hop, us.parts)))
        err = rel_max(lay.gather(mesh_mod.ShardedVector(mesh, out["f"])), ref)
        print(f"halo block stencil, lex {dims[0] - 1}^3 box ({system.ndof} "
              f"DOFs), "
              f"{shards} shards on 1 card, slabs of "
              f"{[len(p) for p in us.parts]} node planes: K.u rel diff vs "
              f"blockstencil.matvec {err:.3e} (tol 1e-12); "
              + commcount.summary("one K.u", comm), flush=True)
        check(err <= 1e-12, f"halo block stencil K.u differs: {err}")
        check(comm == [("neighbor_exchange", (1,) + dims[1:] + (3,),
                        plane)] * 2,
              f"halo block stencil collectives: {comm}")
        if shards == 4:
            comm_kmv = comm
        del hop, us, out
    del bop, ref
    return launches, comm_kmv


def phase25_halo_gather(torch, dev, perm55, system, res9, A_perm,
                        true_rel_residual):
    """Phase 25: the halo-gather tier on the permuted 55^3 box. Returns the
    launches of the sharded run and the collectives of one K.u."""
    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.parallel import commcount, halo_gather
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.solver import stepper

    mesh = mesh_mod.make_mesh(4, device="cuda")
    (hg, pos), t_build = sync_wall(torch, lambda: halo_gather.build(system,
                                                                    mesh))
    idx = torch.as_tensor(halo_gather.dof_order(pos, 3), device=dev)
    lay = hg.layout()
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        system.ndof), device=dev)
    us = lay.scatter(u[idx])
    out = {}
    comm = commcount.collectives(lambda: out.update(
        f=halo_gather.matvec(hg, us.parts)))
    got = torch.empty_like(u).index_copy_(0, idx, lay.gather(
        mesh_mod.ShardedVector(mesh, out["f"])))
    err = rel_max(got, system.matvec(u))
    band = hg.B * 3 * 8
    print(f"halo-gather, permuted 55^3 box ({system.ndof} DOFs), "
          f"{mesh.describe()}: build {t_build:.2f} s, S = {hg.S}, B = {hg.B}"
          f", elements per shard {[b.conn.shape[0] for b in hg.blocks]}; "
          f"K.u rel diff vs System.matvec {err:.3e} (tol 1e-12); "
          + commcount.summary("one K.u", comm), flush=True)
    check(err <= 1e-12, f"halo-gather K.u differs: {err}")
    check(comm == [("neighbor_exchange", (hg.B, 3), band)] * 4,
          f"halo-gather collectives: {comm}")
    check(hg.B < hg.S and 4 * band < system.ndof * 8,
          f"the halo-gather layout is not banded: S {hg.S}, B {hg.B}")
    del hg, us, out, got

    ck.reset_launches()
    res, wall, msgs, cols, solve = traced_run(
        torch, stepper, perm55, Config(device="cuda", n_devices=4))
    launches = dict(ck.launches)
    rel_u = rel_max(res.aggregate_u, res9.aggregate_u)
    true_rel = true_rel_residual(system, A_perm, torch.as_tensor(
        res.aggregate_u, device=dev))
    its, its9 = sum(res.krylov_iters), sum(res9.krylov_iters)
    print(f"sharded halo-gather SA-AMG, permuted 55^3 box, 4 shards on 1 "
          f"card: path {res.path}, iterations {res.krylov_iters} (single "
          f"device, another aggregation order: {res9.krylov_iters}), max "
          f"|du| / max |u| {rel_u:.3e} (tol 1e-9), true rel residual "
          f"{true_rel:.3e}, stepper.run wall {wall:.2f} s (no scaling "
          f"statement), launches {launches}", flush=True)
    print("  " + commcount.summary("the solve", solve)
          + f": {sum(c[2] for c in solve) // its} bytes crossed shards per "
          f"CG iteration", flush=True)
    check_run(res, res9, "sharded_amg_cg", rel_u, true_rel,
              "permuted 55^3 box, 4 shards")
    check(any("DOF-sharded halo-gather operator" in m for m in msgs)
          and any("slab-permuted operator" in m for m in msgs),
          "the permuted 55^3 box did not take the halo-gather tier")
    check(0 < its <= 2 * its9 + 4,
          f"halo-gather iterations {its} against {its9} single-device")
    check({c[2] for c in solve if c[0] == "neighbor_exchange"} == {band}
          and {c[2] for c in solve if c[0] == "all_reduce_sum"} == {8},
          "the solve moved more than bands between neighbours or "
          "all-reduced more than scalars")
    check(launches["csr_matvec"] > 0 and launches["hex8_stiffness"] > 0,
          "the halo-gather run launched no K3 or no K1")
    return launches, comm


def same(a, b, path="deck"):
    """Field-for-field equality of two parsed decks or Problems."""
    import numpy as np

    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        check(list(a) == list(b), f"{path}: keys differ")
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        check(np.asarray(a).dtype == np.asarray(b).dtype
              and np.array_equal(a, b), f"{path} differs")
    else:
        check(a == b and type(a) is type(b), f"{path} differs")


def phase18_native(cli_main):
    """Phase 18: the native parser on the card's host."""
    import numpy as np

    from fem_tpu_torch.io import inp, meshgen, native, vtk
    from fem_tpu_torch.models import problem as problem_mod

    check(native.available(), "native/libfemmesh.so does not load here")
    decks = ["examples/ref/SNES_test/elastic/elastic_test.inp",
             "examples/ref/cohesive_test_2.inp",
             "examples/ref/lin_two_quads_qs.inp",
             "examples/ref/SNES_test/cohesive_test/cohesive_test_2.inp"]
    for deck in decks:
        same(native.parse(deck), inp.parse(deck), deck)
        a = problem_mod.load(deck, backend="native")
        b = problem_mod.load(deck, backend="python")
        # blocks matched by name: the two parsers may order them differently
        check(sorted(a.blocks) == sorted(b.blocks), f"{deck}: blocks differ")
        for name in a.blocks:
            same(a.blocks[name], b.blocks[name], f"{deck}.blocks[{name!r}]")
        for f in dataclasses.fields(a):
            if f.name != "blocks":
                same(getattr(a, f.name), getattr(b, f.name), f"{deck}.{f.name}")
    # load(backend="auto") calls the native engine once per deck
    calls = []
    parse_flat = native.parse_flat
    native.parse_flat = lambda src: calls.append(src) or parse_flat(src)
    try:
        for deck in decks:
            problem_mod.load(deck)
    finally:
        native.parse_flat = parse_flat
    print(f"native: {len(decks)} reference decks parse equal, field for "
          f"field (Deck) and block by block (Problem), by the native and the "
          f"Python parser; load(backend='auto') called native.parse_flat "
          f"{len(calls)} times for {len(decks)} decks", flush=True)
    check(len(calls) == len(decks), "load(backend='auto') did not take the "
          "native engine for every deck")
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli_main(["-f", decks[0], "--parser", "native", "--device",
                       "cuda", "-q", "-o", f"{tmp}/"])
        check(rc == 0, f"CLI --parser native exited {rc}")
        pts, stress, disp = vtk.read_fields(f"{tmp}/0_output_000000.vtk")
        for y, uy in ((2.0, 0.1), (1.0, 0.05)):
            check(np.allclose(disp[pts[:, 1] == y, 1], uy, atol=1e-12),
                  f"--parser native: golden u_y at y={y}")
        check(np.allclose(stress[:, :2], [105.0, 245.0], atol=1e-6)
              and np.allclose(stress[:, 2], 0.0, atol=1e-6),
              "--parser native: golden stress")
        print("native: CLI --parser native --device cuda on the elastic "
              "golden deck: u_y 0.05/0.10, stress 105/245/0 ok", flush=True)
        strip = f"{tmp}/strip.inp"
        with open(strip, "w") as f:
            f.write(meshgen.quad_strip_deck(1000, 200))
        times = {}
        for backend in ("python", "native", "python", "native"):
            t0 = time.perf_counter()
            p = problem_mod.load(strip, backend=backend)
            times.setdefault(backend, []).append(time.perf_counter() - t0)
            check(p.nels == 200000, f"strip parsed to {p.nels} elements")
    print(f"native: host time of load() on the 1000 x 200 strip deck "
          f"(200,000 quads, meshgen.quad_strip_deck): python "
          f"{min(times['python']):.3f} s, native {min(times['native']):.3f} s "
          f"(host times, best of 2)", flush=True)


# the 2D structured row (phases 27-30): the clamped quad cantilever of
# 2048 x 1024 cells, E = 3e10, nu = 0.25 (quad_grid_problem's material)
QUAD_BOX = dict(nx=2048, ny=1024, lx=2.0, ly=1.0, tip_force=(0.0, -1e6))


def quad_csr(torch, t):
    """(indptr int64, indices int32, data) of the matrix of a 2D
    scalar-material grid, formed on the card from K2's 2D tables t: every
    row's nonzero coefficients, columns in order. The yardstick's input
    (the 4.2M-DOF host assembly is too slow for this script); phase 27
    checks its product against the per-corner form. The port never forms
    it."""
    import torch.nn.functional as F

    from fem_tpu_torch.ops import cuda_kernels as ck

    n0, n1 = t.shape
    dev = t.coef.device
    node = torch.arange(n0 * n1, device=dev)
    offs = torch.tensor(ck.stencil_offsets(2), device=dev)
    j0 = node[:, None] // n1 + offs[:, 0]
    j1 = node[:, None] % n1 + offs[:, 1]
    valid = (j0 >= 0) & (j0 < n0) & (j1 >= 0) & (j1 < n1)  # (nodes, 9)
    vals = t.coef[ck._node_classes(t.shape, dev).reshape(-1)].permute(
        0, 2, 1, 3)  # (nodes, p, o, q): a row's entries in column order
    keep = valid[:, None, :, None] & (vals != 0)
    cols = (2 * (j0 * n1 + j1))[:, None, :, None] + torch.arange(2,
                                                                 device=dev)
    indptr = F.pad(torch.cumsum(keep.reshape(2 * n0 * n1, 18).sum(1), 0),
                   (1, 0))
    return (indptr, cols.expand(vals.shape)[keep].to(torch.int32),
            vals[keep].contiguous())


def phase27_k2_2d(torch, dev, flush, csr_library):
    """Phase 27: K2's 2D branch against both plain forms on the quad box's
    node grid and the small and degenerate grids, then timed on the box's
    grid beside its bound, its plain form and cuSPARSE. Returns the float64
    measurements with the max abs error."""
    import numpy as np

    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import structured
    from fem_tpu_torch.ops.stiffness import lame

    lam, mu = lame(torch.tensor(3e10, dtype=torch.float64),
                   torch.tensor(0.25, dtype=torch.float64))
    box = (QUAD_BOX["ny"] + 1, QUAD_BOX["nx"] + 1)  # (ny, nx) node grid
    cells = (QUAD_BOX["lx"] / QUAD_BOX["nx"], QUAD_BOX["ly"] / QUAD_BOX["ny"])

    def inputs(op, dtype):
        k = op.k_ref.to(dtype).contiguous()
        t = (op.tables if dtype == op.k_ref.dtype
             else ck.stencil_tables(k, op.shape))
        u = torch.as_tensor(np.random.default_rng(0).standard_normal(op.ndof),
                            dtype=dtype, device=dev)
        return k, t, u

    err = {}
    for shape in (box, (9, 7), (7, 9), (2, 2), (3, 2), (1, 4), (2, 9)):
        op = structured.build(cells if shape == box else (0.1, 0.2), shape,
                              lam, mu, dtype=torch.float64, device=dev)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            name = str(dtype).split(".")[-1]
            k, t, u = inputs(op, dtype)
            before = ck.launches["stencil_matvec_2d"]
            got = ck.stencil_matvec(t, u)
            again = ck.stencil_matvec(t, u)
            ref = ck.stencil_matvec_plain(k, u, shape)
            ref9 = ck.stencil9_plain(t, u)
            torch.cuda.synchronize()
            check(ck.launches["stencil_matvec_2d"] == before + 2,
                  f"K2 2D {shape}: not two launches of the 2D kernel")
            check(bool(torch.isfinite(got).all()),
                  f"K2 2D {shape}: non-finite")
            check(torch.equal(got, again), f"K2 2D {name} {shape}: two calls "
                  f"gave different bits")
            nref = float(torch.linalg.norm(ref))
            diffs = [float(torch.linalg.norm(got - r)) for r in (ref, ref9)]
            # an axis of one node has no cell: K.u is 0 there, exactly
            rel, rel9 = (d / nref if nref else d for d in diffs)
            print(f"K2 2D {name} {shape}: rel norm diff {rel:.3e} against the "
                  f"per-corner form, {rel9:.3e} against stencil9_plain (tol "
                  f"{tol:.0e})", flush=True)
            check(max(rel, rel9) <= tol,
                  f"K2 2D {name} {shape}: rel diff {rel}, {rel9} > {tol}")
            if dtype == torch.float64:
                err[shape] = float((got - ref).abs().max())

    # times on the box's grid beside cuSPARSE on the box's matrix
    op = structured.build(cells, box, lam, mu, dtype=torch.float64, device=dev)
    nodes = box[0] * box[1]
    out = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        k, t, u = inputs(op, dtype)
        indptr, indices, data = quad_csr(torch, t)
        lib = csr_library(indptr, indices, data, (op.ndof, op.ndof))
        ref = ck.stencil_matvec_plain(k, u, box)
        rel = float(torch.linalg.norm(lib(u) - ref) / torch.linalg.norm(ref))
        print(f"K2 2D {name} {box}: cuSPARSE on the box's matrix "
              f"({data.shape[0]} nonzeros) against the per-corner form: rel "
              f"norm diff {rel:.3e} (tol {tol:.0e})", flush=True)
        check(rel <= tol, f"K2 2D {name}: the box's CSR matrix is not K")
        # least bytes: u in, K.u out, k_ref; least operations: the collapsed
        # 9-point form, 36 FMAs per node
        m = measure(torch, f"K2 2D {box}", name,
                    lambda: ck.stencil_matvec(t, u),
                    lambda: ck.stencil9_plain(t, u), lambda: lib(u),
                    (4 * nodes + 64) * u.element_size(), 2 * 36 * nodes,
                    flush)
        out = out or dict(m, max_abs_err=err[box], shape=list(box))
        del lib, indptr, indices, data
    return out


def profiled(torch, fn):
    """fn() under torch.profiler: (device ms, kernels, stream
    synchronizations, host-to-device copies, host seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = sync_wall(torch, fn)[1]
    dev_ms, kernels, syncs, h2d = 0.0, 0, 0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms += e.self_device_time_total / 1e3
            if e.key.startswith("Memcpy HtoD"):
                h2d += e.count
            elif not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += e.count
    return dev_ms, kernels, syncs, h2d, wall


def phase28_quad_box(torch, dev):
    """Phase 28: the clamped 2D cantilever (4,200,450 DOFs) through
    stepper.run. Returns the run's result, its launches, the problem, its
    stencil operator and its true relative residual as a function of u (for
    phase 30)."""
    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import structured
    from fem_tpu_torch.solver import stepper

    problem = meshgen.quad_grid_problem(**QUAD_BOX)
    check(problem.ndof == 4200450 and problem.nels == 2097152,
          f"the quad box has {problem.ndof} DOFs")
    k2_by_grid, restore_k2 = tally_k2(ck, lambda t, u: t.shape)
    plain, calls = ck.stencil_matvec_plain, []
    setup, steps = stepper._SETUP["structured_mg_cg"], []

    def counted_plain(*args):
        calls.append(1)
        return plain(*args)

    def keeping(*args):
        steps.append(setup(*args))
        return steps[-1]

    ck.stencil_matvec_plain = counted_plain
    stepper._SETUP["structured_mg_cg"] = keeping
    msgs = []
    ck.reset_launches()
    try:
        res, wall = sync_wall(torch, lambda: stepper.run(
            problem, Config(device="cuda", timing=True), log=msgs.append))
    finally:
        restore_k2()
        ck.stencil_matvec_plain = plain
        stepper._SETUP["structured_mg_cg"] = setup
    launches = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(res.path == "structured_mg_cg", f"the quad box took {res.path}")
    check(not calls, f"stencil_matvec_plain ran {len(calls)} times in the "
                     f"run")
    check(launches["stencil_matvec_2d"] > 0
          and launches["stencil_matvec_2d"] == sum(k2_by_grid.values())
          and launches["stencil_matvec"] == 0,
          f"the quad box's K.u did not all go through the 2D kernel: "
          f"{launches}, by grid {k2_by_grid}")
    u = torch.as_tensor(res.aggregate_u, device=dev)
    check(bool(torch.isfinite(u).all())
          and res.aggregate_stress.shape == (problem.nnds, 3)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "quad box solution or stress not finite / wrong shape")
    system, op, rel = structured_box(torch, dev, problem)
    F = system.rhs(0.0)
    true_rel = rel(F, u)
    tip = float(u.reshape(-1, 2)[:, 1].min())
    iters = res.krylov_iters[0]
    # the solve twice more from the same zero start: timed, then under
    # torch.profiler
    zero = torch.zeros_like(F)
    t_solve = sync_wall(torch, lambda: steps[0](F, zero, zero,
                                                problem.dt))[1]
    dev_ms, kernels, syncs, h2d, t_prof = profiled(
        torch, lambda: steps[0](F, zero, zero, problem.dt))
    # the operator alone: 20 fine K.u, and 2 of the per-corner form
    k_h2d = profiled(torch, lambda: [structured.matvec(op, u)
                                     for _ in range(20)])[3]
    p_h2d = profiled(torch, lambda: [ck.stencil_matvec_plain(
        op.k_ref, u, op.shape) for _ in range(2)])[3]
    timers = {k: round(v, 4) for k, v in res.timers.totals.items()}
    print(f"quad box {QUAD_BOX['nx']} x {QUAD_BOX['ny']} ({problem.ndof} "
          f"DOFs, float64): MG-CG iterations {res.krylov_iters}, true rel "
          f"residual {true_rel:.3e}, stepper.run wall {wall:.3f} s (phases "
          f"{timers} s), min u_y {tip:.6e}; 2D kernel launches "
          f"{launches['stencil_matvec_2d']}, by MG level {k2_by_grid}; "
          f"stencil_matvec_plain calls in the run {len(calls)}", flush=True)
    print(f"quad box, the solve again: wall {t_solve * 1e3:.2f} ms; "
          f"profiled: wall {t_prof * 1e3:.2f} ms, device {dev_ms:.2f} ms "
          f"({100 * dev_ms / 1e3 / t_prof:.1f}% busy), {kernels} "
          f"kernels ({kernels / iters:.1f} per CG iteration), "
          f"{syncs} stream synchronizations ({syncs / iters:.1f} per CG "
          f"iteration), {h2d} host-to-device copies ({h2d / iters:.2f} per "
          f"CG iteration); 20 fine K.u {k_h2d} copies, 2 per-corner K.u "
          f"{p_h2d}", flush=True)
    check(true_rel <= 1e-8, f"quad box true rel residual {true_rel} > 1e-8")
    check(tip < 0.0, "quad box: the tip force did not deflect the tip down")
    check(h2d == 0 and k_h2d == 0 and p_h2d == 0,
          f"host-to-device copies: {h2d} in the solve, {k_h2d} in 20 K.u, "
          f"{p_h2d} in 2 per-corner K.u")
    return res, launches, problem, op, lambda v: rel(F, v)


def phase29_strip_cli(torch, dev, cli_main, vtk):
    """Phase 29: the reference's make_example strip, 4096 x 64 quads
    (532,610 DOFs), through the CLI on the card; the strip cut to 256 x 16
    against its CPU run. Returns the big run's launches."""
    import os

    import numpy as np

    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.models import problem as problem_mod
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.solver import stepper

    def run_cli(tmp, nx, ny, device):
        deck = os.path.join(tmp, f"strip_{nx}x{ny}.inp")
        with open(deck, "w") as f:
            f.write(meshgen.quad_strip_deck(nx, ny))
        prefix = os.path.join(tmp, f"{device}_{nx}x{ny}_")
        with kept(problem_mod, "load") as loaded, \
                kept(stepper, "run") as runs:
            rc, wall = sync_wall(torch, lambda: cli_main(
                ["-f", deck, "--device", device, "-o", prefix]))
        check(rc == 0, f"CLI on the {nx} x {ny} strip exited {rc}")
        path = f"{prefix}0_output_000000.vtk"
        check(os.path.exists(path), f"no VTK from the {nx} x {ny} strip")
        return loaded[0], runs[0], vtk.read_fields(path), wall

    with tempfile.TemporaryDirectory() as tmp:
        ck.reset_launches()
        problem, res, fields, wall = run_cli(tmp, 4096, 64, "cuda")
        launches = dict(ck.launches)
        check(problem.ndof == 532610, f"the strip has {problem.ndof} DOFs")
        check(res.path == "structured_mg_cg", f"the strip took {res.path}")
        pts, stress, disp = fields
        check(pts.shape[0] == problem.nnds and np.isfinite(disp).all()
              and np.isfinite(stress).all(), "the strip's VTK fields")
        system, op, rel = structured_box(torch, dev, problem)
        true_rel = rel(system.rhs(0.0),
                       torch.as_tensor(res.aggregate_u, device=dev))
        print(f"make_example strip 4096 x 64 ({problem.ndof} DOFs) via the "
              f"CLI on cuda: path {res.path}, MG-CG iterations "
              f"{res.krylov_iters}, true rel residual {true_rel:.3e}, CLI "
              f"wall {wall:.2f} s, VTK of {pts.shape[0]} points, launches "
              f"{launches}", flush=True)
        check(true_rel <= 1e-8, f"strip true rel residual {true_rel} > 1e-8")
        check(launches["stencil_matvec_2d"] > 0,
              "the strip launched no 2D kernel")
        del system, op
        small = {d: run_cli(tmp, 256, 16, d) for d in ("cuda", "cpu")}
    got, ref = (small[d][1] for d in ("cuda", "cpu"))
    d_u = rel_max(got.aggregate_u, ref.aggregate_u)
    d_s = rel_max(got.aggregate_stress, ref.aggregate_stress)
    # the VTK prints six decimals: its fields agree to 1e-9 of the largest
    # entry or to one unit of the sixth decimal, whichever is coarser
    vtk_ok = all(
        np.abs(a - b).max() <= max(1e-9 * np.abs(b).max(), 1.5e-6)
        for a, b in zip(small["cuda"][2], small["cpu"][2]))
    print(f"make_example strip 256 x 16 via the CLI: cuda against cpu, "
          f"paths {got.path} / {ref.path}, iterations {got.krylov_iters} / "
          f"{ref.krylov_iters}, max |du| / max |u| {d_u:.3e}, stress "
          f"{d_s:.3e} (tol 1e-9), VTK fields equal to their printed "
          f"precision: {vtk_ok}", flush=True)
    check(got.path == ref.path == "structured_mg_cg",
          f"the 256 x 16 strip took {got.path} / {ref.path}")
    check(max(d_u, d_s) <= 1e-9 and vtk_ok, "the 256 x 16 strip: cuda != cpu")
    return launches


def phase30_slab_2d(torch, dev, problem, op, true_rel_of, res28):
    """Phase 30: the 2D slab-sharded row on phase 28's box, slabs along y
    (the leading axis of the (ny, nx) node grid), 4 and 3 shards on this
    card. Returns the launches of the two runs."""
    import os

    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import structured
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.solver import stepper

    os.environ[mesh_mod.VIRTUAL_ENV] = "4"
    n0, n1 = op.shape
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(op.ndof),
                        device=dev)
    ref = structured.matvec(op, u)
    launches = {}
    for shards in (4, 3):
        sl = structured.shard_slabs(op, mesh_mod.make_mesh(shards,
                                                           device="cuda"))
        ck.reset_launches()
        err = rel_max(structured.matvec_sharded(sl, u), ref)
        k2 = ck.launches["stencil_matvec_2d"]
        print(f"2D slab stencil, {shards} shards (slabs "
              f"{[e - s for s, e in sl.bounds]} cells along y): "
              f"matvec_sharded rel diff {err:.3e} (tol 1e-12), 2D kernel "
              f"launches {k2}", flush=True)
        check(err <= 1e-12, f"2D matvec_sharded, {shards} shards: {err}")
        check(k2 == shards, f"2D matvec_sharded launched {k2} 2D kernels")
        slab_grids = {(e - s + 1, n1) for s, e in sl.bounds}
        del sl
        k2_by_grid, restore_k2 = tally_k2(ck, lambda t, v: t.shape)
        ck.reset_launches()
        try:
            res, wall, msgs, cols, solve = traced_run(
                torch, stepper, problem, Config(device="cuda",
                                                n_devices=shards))
        finally:
            restore_k2()
        launches[shards] = dict(ck.launches)
        rel_u = rel_max(res.aggregate_u, res28.aggregate_u)
        true_rel = true_rel_of(torch.as_tensor(res.aggregate_u, device=dev))
        ar = [c[2] for c in solve if c[0] == "all_reduce_sum"]
        on_slabs = {g: k for g, k in k2_by_grid.items()
                    if g[0] < n0 and g[1] == n1}
        print(f"sharded slab stencil, 2D quad box, {shards} shards on 1 card: "
              f"path {res.path}, MG-CG iterations {res.krylov_iters} (single "
              f"device {res28.krylov_iters}), max |du| / max |u| "
              f"{rel_u:.3e} (tol 1e-9), true rel residual {true_rel:.3e}, "
              f"{len(ar)} all-reduces in the solve, stepper.run wall "
              f"{wall:.2f} s (no scaling statement), 2D kernel launches "
              f"{launches[shards]['stencil_matvec_2d']}, on slab grids "
              f"{on_slabs}", flush=True)
        check_run(res, res28, "sharded_slab_stencil", rel_u, true_rel,
                  f"2D quad box, {shards} shards")
        check(all(abs(i - j) <= 1 for i, j in zip(res.krylov_iters,
                                                  res28.krylov_iters)),
              f"2D sharded MG-CG iterations {res.krylov_iters} against "
              f"{res28.krylov_iters}")
        check(set(on_slabs) == slab_grids and len(ar) * shards
              == sum(on_slabs.values()),
              f"the 2D kernel did not run once per slab per fine K.u: "
              f"{k2_by_grid}")
    return launches[4], launches[3]


def deck_constants(names):
    """The deck texts named `names` in tests/test_3d_decks.py, read with ast
    (that file imports the JAX package; this script imports nothing of
    it)."""
    import ast
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / (
        "test_3d_decks.py")
    decks = {target.id: ast.literal_eval(node.value)
             for node in ast.parse(path.read_text()).body
             if isinstance(node, ast.Assign)
             for target in node.targets
             if isinstance(target, ast.Name) and target.id in names}
    check(set(decks) == set(names), f"decks missing from {path}")
    return decks


def phase31_plane_stress(torch, dev, res28):
    """Phase 31: phase 28's quad box under plane stress through stepper.run,
    its true residual against the plane-stress System's K applied by the
    fused operator; the same with 4 slab shards; the 3D decks of
    tests/test_3d_decks.py on cuda against cpu. Returns the launches of the
    three runs."""
    import os

    import numpy as np

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen
    from fem_tpu_torch.models import problem as problem_mod
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import operator, structured
    from fem_tpu_torch.parallel import mesh as mesh_mod
    from fem_tpu_torch.solver import cg, stepper

    problem = meshgen.quad_grid_problem(**QUAD_BOX)
    k2_by_grid, restore_k2 = tally_k2(ck, lambda t, u: t.shape)
    plain, calls = ck.stencil_matvec_plain, []

    def counted_plain(*args):
        calls.append(1)
        return plain(*args)

    ck.stencil_matvec_plain = counted_plain
    msgs = []
    ck.reset_launches()
    try:
        res, wall = sync_wall(torch, lambda: stepper.run(
            problem, Config(device="cuda", plane_stress=True, timing=True),
            log=msgs.append))
    finally:
        restore_k2()
        ck.stencil_matvec_plain = plain
    launches = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(res.path == "structured_mg_cg",
          f"the plane-stress quad box took {res.path}")
    check(not calls, f"stencil_matvec_plain ran {len(calls)} times in the "
                     f"plane-stress run")
    check(launches["stencil_matvec_2d"] > 0
          and launches["stencil_matvec_2d"] == sum(k2_by_grid.values())
          and launches["stencil_matvec"] == 0,
          f"the plane-stress box's K.u did not all go through the 2D "
          f"kernel: {launches}, by grid {k2_by_grid}")
    check(bool(np.isfinite(res.aggregate_u).all())
          and res.aggregate_stress.shape == (problem.nnds, 3)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "plane-stress quad box: solution or stress not finite / wrong "
          "shape")

    # K of the plane-stress System, applied by the fused operator (gather,
    # products, index_add_), which takes its material from System and
    # shares no code with the stencil
    system = System(problem, torch.float64, device=dev, plane_stress=True)
    fused = operator.build(system)
    mask = torch.zeros(problem.ndof, dtype=torch.bool, device=dev)
    mask[system.bc_dofs] = True
    F = system.rhs(0.0)

    def fused_k(v):
        return operator.matvec(fused, v)

    def true_rel_of(u):
        b = cg.constrained_rhs(fused_k, F, mask, torch.zeros_like(u))
        r = b - cg.masked_operator(fused_k, mask)(u)
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    u = torch.as_tensor(res.aggregate_u, device=dev)
    true_rel = true_rel_of(u)
    # the stencil the stepper builds against the fused operator on one
    # vector, and the residual that the plane-strain stencil reads of this u
    # (the parent's fault: CG converged on that K)
    op = structured.operator_for(system, structured.detect(problem))
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(op.ndof),
                        device=dev)
    k_err = rel_max(structured.matvec(op, v), fused_k(v))
    del op
    strain_rel = structured_box(torch, dev, problem)[2](F, u)
    tip = float(u.reshape(-1, 2)[:, 1].min())
    tip28 = float(res28.aggregate_u.reshape(-1, 2)[:, 1].min())
    timers = {k: round(v, 4) for k, v in res.timers.totals.items()}
    print(f"plane-stress quad box {QUAD_BOX['nx']} x {QUAD_BOX['ny']} "
          f"({problem.ndof} DOFs, float64): path {res.path}, MG-CG "
          f"iterations {res.krylov_iters} (plane strain {res28.krylov_iters})"
          f", true rel residual against the fused operator {true_rel:.3e}, "
          f"stepper.run wall {wall:.3f} s (phases {timers} s), min u_y "
          f"{tip:.6e} ({tip / tip28:.6f} x plane strain's); 2D kernel "
          f"launches {launches['stencil_matvec_2d']}, by MG level "
          f"{k2_by_grid}; stencil_matvec_plain calls in the run "
          f"{len(calls)}; operator_for's stencil against the fused operator "
          f"{k_err:.3e}; the plane-strain stencil's residual of this u "
          f"{strain_rel:.3e}", flush=True)
    check(true_rel <= 1e-8,
          f"plane-stress quad box true rel residual {true_rel} > 1e-8")
    check(k_err <= 1e-12, f"operator_for's stencil != System's K: {k_err}")
    check(strain_rel > 1e-4, f"the plane-strain stencil also accepts the "
                             f"plane-stress u ({strain_rel}): the residual "
                             f"check cannot tell the two apart")
    check(tip < tip28 < 0.0,
          "plane stress did not deflect the tip further than plane strain")

    os.environ[mesh_mod.VIRTUAL_ENV] = "4"
    k2_by_grid, restore_k2 = tally_k2(ck, lambda t, v: t.shape)
    ck.reset_launches()
    try:
        res4, wall4, _, _, solve = traced_run(
            torch, stepper, problem,
            Config(device="cuda", plane_stress=True, n_devices=4))
    finally:
        restore_k2()
    launches4 = dict(ck.launches)
    rel_u = rel_max(res4.aggregate_u, res.aggregate_u)
    true_rel4 = true_rel_of(torch.as_tensor(res4.aggregate_u, device=dev))
    ar = [c for c in solve if c[0] == "all_reduce_sum"]
    print(f"plane-stress quad box, 4 slab shards on 1 card: path "
          f"{res4.path}, MG-CG iterations {res4.krylov_iters}, max |du| / "
          f"max |u| against the single-device run {rel_u:.3e} (tol 1e-9), "
          f"true rel residual {true_rel4:.3e}, {len(ar)} all-reduces in the "
          f"solve, stepper.run wall {wall4:.2f} s, 2D kernel launches "
          f"{launches4['stencil_matvec_2d']}, by grid {k2_by_grid}",
          flush=True)
    check_run(res4, res, "sharded_slab_stencil", rel_u, true_rel4,
              "plane-stress quad box, 4 shards")
    check(all(abs(i - j) <= 1 for i, j in zip(res4.krylov_iters,
                                              res.krylov_iters)),
          f"plane-stress sharded MG-CG iterations {res4.krylov_iters} "
          f"against {res.krylov_iters}")
    del system, fused, u, v, F

    # the 3D decks: a hex face traction, a tet point force, traction
    # records on a hex face and a tet face at once. The direct rows agree to
    # round-off; the Jacobi-CG rows stop at rtol 1e-9, and on the mixed
    # deck (its tet is inverted: a non-positive Jacobian) two such iterates
    # differ by a few 1e-10 of max |u|, so they are held to 1e-8, as the
    # CPU parity test of these decks holds them against fem_tpu
    decks = deck_constants(("HEX_DECK", "TET_DECK", "MIXED_TRAC_DECK"))
    ck.reset_launches()
    for name, text in decks.items():
        for solver, tol in (("direct", 1e-10), ("cg", 1e-8)):
            got, ref = (stepper.run(problem_mod.load(text),
                                    Config(device=d, solver=solver))
                        for d in ("cuda", "cpu"))
            d_u = rel_max(got.aggregate_u, ref.aggregate_u)
            d_s = rel_max(got.aggregate_stress, ref.aggregate_stress)
            print(f"3D deck {name}, --solver {solver}: cuda against cpu, "
                  f"paths {got.path} / {ref.path}, iterations "
                  f"{got.krylov_iters} / {ref.krylov_iters}, max |du| / max "
                  f"|u| {d_u:.3e}, stress {d_s:.3e} (tol {tol:.0e})",
                  flush=True)
            check(got.path == ref.path and got.krylov_iters
                  == ref.krylov_iters and max(d_u, d_s) <= tol,
                  f"3D deck {name}, {solver}: cuda != cpu")
    launches_decks = dict(ck.launches)
    print(f"3D decks on cuda: launches {launches_decks}", flush=True)
    check(launches_decks["hex8_stiffness"] > 0,
          "the hex decks on cuda launched no K1")
    return launches, launches4, launches_decks


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    import numpy as np

    from fem_tpu_torch import kernels_build
    from fem_tpu_torch.cli import main as cli_main
    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import meshgen, vtk
    from fem_tpu_torch.models import problem as problem_mod
    from fem_tpu_torch.models.system import System
    from fem_tpu_torch.ops import cohesive as coh_ops
    from fem_tpu_torch.ops import cuda_kernels as ck
    from fem_tpu_torch.ops import operator, structured
    from fem_tpu_torch.ops.stiffness import lame
    from fem_tpu_torch.solver import (amg, cg, hierarchy, multigrid, newton,
                                      stepper)

    # float32 products in the plain versions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels_build.build()
    kernels_build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s "
          f"({lib_path.name})", flush=True)
    for line in lib_path.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    summary = {}
    # read before each cold launch: 256 MB, five times the L2
    flush = torch.ones(32 * 2**20, dtype=torch.float64, device=dev)

    def csr_library(indptr, indices, data, shape):
        """The yardstick of K3: `torch.mv` on a torch sparse CSR tensor (int32
        indices; cuSPARSE's SpMV). The port never calls it."""
        A = torch.sparse_csr_tensor(indptr.to(torch.int32),
                                    indices.to(torch.int32), data,
                                    size=shape, check_invariants=False)
        return lambda x: torch.mv(A, x)

    stamp("phase 3: K1")
    # 3. K1 against its plain version
    base = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=float)

    def k1_inputs(ne, dtype, seed=0):
        rng = np.random.default_rng(seed)
        ec = np.transpose(base[None] + 0.05 * rng.normal(size=(ne, 8, 3)),
                          (2, 1, 0))
        lam = rng.uniform(1, 2, ne)
        mu = rng.uniform(1, 2, ne)
        return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=dev) for a in (ec, lam, mu)]

    def k1_case(args, tol, label):
        got = ck.hex8_stiffness(*args)
        ref = ck.hex8_stiffness_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        asym = float((got - got.transpose(0, 1)).abs().max()) / float(
            ref.abs().max())
        print(f"K1 {label}: max rel diff {rel:.3e} (tol {tol:.0e}), "
              f"asymmetry {asym:.3e}", flush=True)
        check(rel <= tol, f"K1 {label}: max rel diff {rel} > {tol}")
        return err

    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        args = k1_inputs(131072, dtype)
        err = k1_case(args, tol, f"{name} ne=131072")
        # least bytes: (3, 8, ne) coordinates and lam, mu in, (24, 24, ne)
        # out; least operations: one FMA per k_e entry and Gauss point
        isz = args[0].element_size()
        m = measure(torch, "K1 ne=131072", name,
                    lambda: ck.hex8_stiffness(*args),
                    lambda: ck.hex8_stiffness_plain(*args), None,
                    (26 + 576) * 131072 * isz, 2 * 8 * 576 * 131072, flush,
                    reps=20, plain_reps=5)
        if dtype == torch.float64:
            summary["hex8_stiffness"] = dict(m, max_abs_err=err)
        k1_case(k1_inputs(300, dtype, seed=1), tol, f"{name} ne=300")
        # the structured build's reference pair: one cell, (lam, mu) = (1, 0)
        # and (0, 1)
        cell = torch.as_tensor(base / 80.0, dtype=dtype, device=dev)
        pair = [torch.stack([cell, cell]).permute(2, 1, 0).contiguous(),
                torch.tensor([1.0, 0.0], dtype=dtype, device=dev),
                torch.tensor([0.0, 1.0], dtype=dtype, device=dev)]
        k1_case(pair, tol, f"{name} ne=2 (k_lam/k_mu pair)")

    stamp("phase 4: K2")
    # 4. K2 against its plain version
    lam_s, mu_s = lame(torch.tensor(200e9, dtype=torch.float64),
                       torch.tensor(0.3, dtype=torch.float64))
    k2_tols = ((torch.float64, 1e-12), (torch.float32, 1e-6))

    def k2_inputs(op, dtype):
        """(k_ref, K2's tables, u) of op in dtype on the card: the tables the
        operator holds in its own dtype, else built anew."""
        rng = np.random.default_rng(0)
        k = op.k_ref.to(dtype).contiguous()
        t = (op.tables if dtype == op.k_ref.dtype
             else ck.stencil_tables(k, op.shape))
        return (k, t, torch.as_tensor(rng.standard_normal(op.ndof),
                                      dtype=dtype, device=dev))

    def k2_case(op):
        """K2 against the per-corner form and its own plain version, in
        float64 and float32, and the same bits on a second call; returns the
        float64 max abs error."""
        shape = op.shape
        for dtype, tol in k2_tols:
            name = str(dtype).split(".")[-1]
            k, t, u = k2_inputs(op, dtype)
            got = ck.stencil_matvec(t, u)
            again = ck.stencil_matvec(t, u)
            ref = ck.stencil_matvec_plain(k, u, shape)
            ref27 = ck.stencil27_plain(t, u)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"K2 {shape}: non-finite")
            check(torch.equal(got, again), f"K2 {name} {shape}: two calls "
                  f"gave different bits")
            nref = float(torch.linalg.norm(ref))
            diffs = [float(torch.linalg.norm(got - r)) for r in (ref, ref27)]
            # an axis of one node has no cell: K.u is 0 there, exactly
            rel, rel27 = (d / nref if nref else d for d in diffs)
            print(f"K2 {name} {shape}: rel norm diff {rel:.3e} against the "
                  f"per-corner form, {rel27:.3e} against the tables' plain "
                  f"form (tol {tol:.0e})", flush=True)
            check(max(rel, rel27) <= tol,
                  f"K2 {name} {shape}: rel diff {rel}, {rel27} > {tol}")
            if dtype == torch.float64:
                err = float((got - ref).abs().max())
        return err

    def k2_measure(op, A_csr):
        """K2's times on op's grid beside cuSPARSE on the assembled matrix of
        the same box (checked to be the same function); returns the float64
        measurements."""
        shape, nodes = op.shape, int(np.prod(op.shape))
        out = None
        # the assembled matrix rounds k_e's sums in another order: in float32
        # the two agree to a few ulps of the larger terms, not of K.u
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            name = str(dtype).split(".")[-1]
            _, t, u = k2_inputs(op, dtype)
            lib = csr_library(
                torch.as_tensor(A_csr.indptr, device=dev),
                torch.as_tensor(A_csr.indices, device=dev),
                torch.as_tensor(A_csr.data, dtype=dtype, device=dev),
                A_csr.shape)
            got = ck.stencil_matvec(t, u)
            rel = float(torch.linalg.norm(lib(u) - got)
                        / torch.linalg.norm(got))
            print(f"K2 {name} {shape}: rel norm diff against the assembled "
                  f"matrix ({A_csr.nnz} nonzeros) {rel:.3e}", flush=True)
            check(rel <= tol, f"K2 {name} {shape} vs assembled: {rel}")
            # least bytes: u in, K.u out, k_ref; least operations: the
            # collapsed 27-point form, 243 FMAs per node
            m = measure(torch, f"K2 {shape}", name,
                        lambda: ck.stencil_matvec(t, u),
                        lambda: ck.stencil27_plain(t, u),
                        lambda: lib(u),
                        (6 * nodes + 576) * u.element_size(),
                        2 * 243 * nodes, flush)
            out = out or m
        return out

    for shape, cells in (((81, 81, 81), (1 / 80,) * 3),
                         ((9, 7, 6), (0.1, 0.2, 0.15)),
                         ((2, 2, 2), (0.1, 0.2, 0.15)),
                         ((3, 2, 9), (0.1, 0.2, 0.15)),
                         ((1, 4, 5), (0.1, 0.2, 0.15))):
        k2_err = k2_case(structured.build(cells, shape, lam_s, mu_s,
                                          dtype=torch.float64, device=dev))
        if shape == (81, 81, 81):
            k2_err81 = k2_err
    # the unjittered 55^3 box (56^3 nodes): K2 beside cuSPARSE on its
    # assembled matrix
    box56 = meshgen.hex_box_problem(55, 55, 55, lx=1.0, ly=1.0, lz=1.0,
                                    E=200e9, nu=0.3)
    spec56 = structured.detect(box56)
    op56 = structured.build(spec56["cell_sizes"], spec56["node_shape"], lam_s,
                            mu_s, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    A56 = amg.assemble_csr(System(box56, torch.float64, device=dev))
    print(f"56^3 nodes: assemble_csr {time.perf_counter() - t0:.2f} s",
          flush=True)
    k2_measure(op56, A56)
    del A56

    stamp("phase 5-7: golden deck, direct box, 80^3 solve")
    # 5. CLI on the elastic golden deck, on the card
    deck = "examples/ref/SNES_test/elastic/elastic_test.inp"
    with tempfile.TemporaryDirectory() as tmp:
        rc = cli_main(["-f", deck, "--device", "cuda", "-q",
                       "-o", f"{tmp}/"])
        check(rc == 0, f"CLI exited {rc}")
        pts, stress, disp = vtk.read_fields(f"{tmp}/0_output_000000.vtk")
    for y, uy in ((2.0, 0.1), (1.0, 0.05)):
        rows = pts[:, 1] == y
        check(np.allclose(disp[rows, 1], uy, atol=1e-12),
              f"golden u_y at y={y}: {disp[rows, 1]}")
    check(np.allclose(stress[:, :2], [105.0, 245.0], atol=1e-6)
          and np.allclose(stress[:, 2], 0.0, atol=1e-6),
          f"golden stress: {stress}")
    print("CLI elastic golden on cuda: u_y 0.05/0.10, stress 105/245/0 ok",
          flush=True)

    # 6. small hex box, direct path: K1 assembles k_e
    box = meshgen.hex_box_problem(6, 6, 6, lx=1.0, ly=1.0, lz=1.0)
    ck.reset_launches()
    r_gpu = stepper.run(box, Config(device="cuda"))
    k1_direct = ck.launches["hex8_stiffness"]
    r_cpu = stepper.run(box, Config(device="cpu"))
    rel = float(np.abs(r_gpu.aggregate_u - r_cpu.aggregate_u).max()
                / np.abs(r_cpu.aggregate_u).max())
    print(f"direct hex box 6^3 ({box.ndof} DOFs, path {r_gpu.path}): "
          f"K1 launches {k1_direct}, rel diff vs CPU {rel:.3e}", flush=True)
    check(r_gpu.path == "direct", f"expected the direct path, got {r_gpu.path}")
    check(k1_direct > 0, "the direct path launched no K1")
    check(rel <= 1e-9, f"direct hex box: GPU vs CPU rel diff {rel}")

    # 7. the 80^3 structured solve
    big = meshgen.hex_box_problem(80, 80, 80, lx=1.0, ly=1.0, lz=1.0,
                                  E=200e9, nu=0.3, tip_load=-1e6)
    check(big.ndof == 1594323, f"80^3 box has {big.ndof} DOFs")
    torch.cuda.synchronize()
    # K2's calls by node grid (MG level), tallied around the wrapper
    k2_by_grid, restore_k2 = tally_k2(ck, lambda t, u: t.shape)
    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        res = stepper.run(big, Config(device="cuda"))
        torch.cuda.synchronize()
    finally:
        restore_k2()
    wall = time.perf_counter() - t0
    launches = dict(ck.launches)
    print(f"80^3 box: K2 calls by node grid {k2_by_grid}", flush=True)
    check(sum(k2_by_grid.values()) == launches["stencil_matvec"],
          "K2's calls and launches differ")
    check(res.path == "structured_mg_cg", f"80^3 box took path {res.path}")
    u = torch.as_tensor(res.aggregate_u, dtype=torch.float64, device=dev)
    check(bool(torch.isfinite(u).all()), "80^3 solution is not finite")
    check(res.aggregate_stress.shape == (big.nnds, 6)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "80^3 stress is not finite or has the wrong shape")
    # true residual of the masked system, with the per-corner form
    system, op, rel = structured_box(torch, dev, big)
    true_rel = rel(system.rhs(0.0), u)
    tip = float(u.reshape(-1, 3)[:, 2].min())
    print(f"80^3 box ({big.ndof} DOFs, float64): MG-CG iterations "
          f"{res.krylov_iters}, true rel residual {true_rel:.3e}, wall "
          f"{wall:.2f} s, min u_z {tip:.6e}, launches {launches}",
          flush=True)
    check(true_rel <= 1e-8, f"80^3 true relative residual {true_rel} > 1e-8")
    # a wrong K2 on a coarse level weakens the preconditioner, not the
    # residual: the iteration count shows it
    check(len(res.krylov_iters) > 0
          and all(abs(i - 12) <= 1 for i in res.krylov_iters),
          f"80^3 MG-CG iterations {res.krylov_iters}, not 12 +- 1")
    check(tip < 0.0, "80^3 box: the tip load did not deflect the tip down")
    res7 = res  # phase 23 shards this run
    for name in ("hex8_stiffness", "stencil_matvec"):
        check(launches[name] > 0, f"the 80^3 run launched no {name}")
    # K2 on every level's operator of that run's hierarchy, built as the
    # stepper builds it
    hier = multigrid.build(op, system.bc_dofs)
    level_shapes = [lv.op.shape for lv in hier.levels]
    check(set(level_shapes) == set(k2_by_grid),
          f"MG levels {level_shapes} are not the grids K2 ran on "
          f"{sorted(k2_by_grid)}")
    for lv in hier.levels:
        k2_case(lv.op)
    del hier
    # K2 on this run's 81^3 grid beside cuSPARSE on the box's assembled matrix
    t0 = time.perf_counter()
    A_big = amg.assemble_csr(system)
    print(f"80^3 box: assemble_csr {time.perf_counter() - t0:.2f} s",
          flush=True)
    summary["stencil_matvec"] = dict(k2_measure(op, A_big),
                                     max_abs_err=k2_err81)
    del A_big

    stamp("phase 8: K3")
    # 8. K3 against its plain version on a random table
    def k3_case(t, x, label, reps=50):
        """K3 (table t, an amg.Csr) against its plain version in float64 and
        float32, the same bits on a second call, and its times beside
        cuSPARSE on the same CSR; returns the float64 measurements."""
        n, ncols = t.shape
        nnz = t.data.shape[0]
        print(f"K3 {label}: n {n}, {nnz} nonzeros, "
              f"{nnz / max(n, 1):.1f} per row, lanes {t.lanes}", flush=True)
        out = None
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            name = str(dtype).split(".")[-1]
            tt = dataclasses.replace(t, data=t.data.to(dtype))
            xx = x.to(dtype)
            got = tt(xx)
            again = tt(xx)
            ref = ck.csr_matvec_plain(tt.indptr, tt.indices, tt.data, xx)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"K3 {label}: non-finite")
            check(torch.equal(got, again), f"K3 {name} {label}: two calls "
                  f"gave different bits")
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-300)
            print(f"K3 {name} {label}: max rel diff {rel:.3e} (tol "
                  f"{tol:.0e})", flush=True)
            check(rel <= tol, f"K3 {name} {label}: max rel diff {rel} > {tol}")
            lib = csr_library(tt.indptr, tt.indices, tt.data, (n, ncols))
            lib_rel = float((lib(xx) - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-300)
            check(lib_rel <= tol, f"K3 {name} {label}: cuSPARSE {lib_rel}")
            # least bytes: each nonzero's value and int32 column, x, out
            m = measure(torch, f"K3 {label}", name, lambda: tt(xx),
                        lambda: ck.csr_matvec_plain(tt.indptr, tt.indices,
                                                    tt.data, xx),
                        lambda: lib(xx),
                        nnz * (tt.data.element_size() + 4)
                        + (n + ncols) * tt.data.element_size(),
                        2 * nnz, flush, reps=reps)
            out = out or dict(m, max_abs_err=err)
        return out

    def k3_hierarchy(hier, label):
        """k3_case on every P, R and ELL mid-level table of an SA-AMG
        hierarchy; returns level 0's P result."""
        first = None
        for i, lv in enumerate(hier.levels[:-1]):
            n_f = lv.dinv.shape[0]
            tables = [("P", lv.P, lv.n_coarse), ("R", lv.R, n_f)]
            if lv.op is not None:
                tables.append(("A (CSR mid level)", lv.op, n_f))
            for name, t, nx in tables:
                x = torch.as_tensor(rng.standard_normal(nx), device=dev)
                res_k3 = k3_case(t, x, f"{label} level {i} {name}")
                first = first or res_k3
        check(first is not None,
              f"the {label} hierarchy has no transfer level")
        return first

    rng = np.random.default_rng(0)
    n_r = 200000
    # 81 random nonzeros in each row (the ELL table of earlier runs)
    vals = rng.standard_normal((81, n_r))
    cols = rng.integers(0, n_r, (81, n_r))
    k3_case(amg.Csr(torch.arange(0, 81 * n_r + 1, 81, device=dev),
                    torch.as_tensor(cols.T.reshape(-1), dtype=torch.int32,
                                    device=dev),
                    torch.as_tensor(vals.T.reshape(-1), device=dev), n_r,
                    ck.csr_lanes(n_r, 81 * n_r)),
            torch.as_tensor(rng.standard_normal(n_r), device=dev),
            "random n=200000 w=81")
    del vals, cols

    stamp("phase 9: permuted 55^3 box")
    # 9. the permuted 55^3 box: set-up phases, K3 on the real tables, and
    # stepper.run through SA-AMG
    def box55(permute):
        p = meshgen.hex_box_problem(55, 55, 55, lx=1.0, ly=1.0, lz=1.0,
                                    E=200e9, nu=0.3, tip_load=-1e6,
                                    jitter=0.25, seed=0)
        p = meshgen.permute_nodes(p, seed=0) if permute else p
        check(p.ndof == 526848, f"55^3 box has {p.ndof} DOFs")
        return p

    def true_rel_residual(system, A_csr, u):
        """||b - K u|| / ||b|| of the masked system, K from assemble_csr as
        a torch sparse CSR product on the card (a check, not the path)."""
        K = torch.sparse_csr_tensor(
            torch.as_tensor(A_csr.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(A_csr.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(A_csr.data, dtype=torch.float64, device=dev),
            size=A_csr.shape, check_invariants=True)

        def kmv(v):
            return (K @ v.unsqueeze(1)).squeeze(1)

        mask = torch.zeros(system.ndof, dtype=torch.bool, device=dev)
        mask[system.bc_dofs] = True
        b = cg.constrained_rhs(kmv, system.rhs(0.0), mask, torch.zeros_like(u))
        r = b - cg.masked_operator(kmv, mask)(u)
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    perm = box55(permute=True)
    # the run first, its hierarchy kept as stepper.run builds it (one
    # amg.build, not a second one for the tables)
    ck.reset_launches()
    msgs = []
    with kept(hierarchy, "build") as built:
        res, wall = sync_wall(torch, lambda: stepper.run(
            perm, Config(device="cuda"), log=msgs.append))
    launches_amg = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(len(built) == 1 and built[0].kind == "amg",
          f"the permuted 55^3 run built {[b.kind for b in built]}")
    # K3 on that run's own P, R and mid-level tables; the hierarchy and its
    # fine operator are kept for phase 17's gradients
    amg55 = built.pop()
    k3_real = k3_hierarchy(amg55.hier, "55^3")
    system = System(perm, torch.float64, device=dev)
    mask55 = torch.zeros(system.ndof, dtype=torch.bool, device=dev)
    mask55[system.bc_dofs] = True
    A_csr, t_asm = sync_wall(torch, lambda: amg.assemble_csr(system))
    print(f"permuted 55^3 box ({perm.ndof} DOFs): assemble_csr {t_asm:.2f} s "
          f"({A_csr.nnz} nonzeros)", flush=True)
    # the assembled matrix (measured only: the SA branch's fine operator is
    # the fused operator)
    k3_case(amg.Csr.from_csr(A_csr, torch.float64, dev),
            torch.as_tensor(rng.standard_normal(A_csr.shape[0]), device=dev),
            "55^3 assembled A", reps=20)
    check(res.path == "unstructured_amg_or_lattice_gmg_cg",
          f"permuted 55^3 box took path {res.path}")
    check(any("smoothed aggregation" in m for m in msgs)
          and not any("Lattice topology" in m or "lattice-MG" in m
                      for m in msgs),
          "the permuted 55^3 box did not take the fused operator and SA-AMG")
    u = torch.as_tensor(res.aggregate_u, device=dev)
    check(bool(torch.isfinite(u).all())
          and res.aggregate_stress.shape == (perm.nnds, 6)
          and bool(np.isfinite(res.aggregate_stress).all()),
          "permuted 55^3 solution or stress not finite / wrong shape")
    true_rel = true_rel_residual(system, A_csr, u)
    print(f"permuted 55^3 box ({perm.ndof} DOFs, float64): SA-AMG-CG "
          f"iterations {res.krylov_iters}, true rel residual {true_rel:.3e}, "
          f"stepper.run wall {wall:.2f} s, min u_z "
          f"{float(u.reshape(-1, 3)[:, 2].min()):.6e}, launches "
          f"{launches_amg}", flush=True)
    check(true_rel <= 1e-8, f"permuted 55^3 true rel residual {true_rel}")
    for name in ("hex8_stiffness", "csr_matvec"):
        check(launches_amg[name] > 0, f"the SA-AMG run launched no {name}")
    # phases 22 and 25 shard this run
    perm55, res9, A_perm = perm, res, A_csr
    del system, A_csr, u

    stamp("phase 10: lex 55^3 box")
    # 10. the lex-ordered 55^3 box: block stencil + lattice GMG
    lex = box55(permute=False)
    ck.reset_launches()
    msgs = []
    res, wall = sync_wall(torch, lambda: stepper.run(
        lex, Config(device="cuda"), log=msgs.append))
    launches_gmg = dict(ck.launches)
    for m in msgs:
        if "Interval" not in m:
            print(f"  stepper: {m.strip()}")
    check(res.path == "unstructured_amg_or_lattice_gmg_cg",
          f"lex 55^3 box took path {res.path}")
    check(any("Geometric lattice-MG" in m for m in msgs)
          and not any("demotion" in m for m in msgs),
          "the lex 55^3 box did not solve with lattice GMG")
    system = System(lex, torch.float64, device=dev)
    u = torch.as_tensor(res.aggregate_u, device=dev)
    check(bool(torch.isfinite(u).all())
          and bool(np.isfinite(res.aggregate_stress).all()),
          "lex 55^3 solution or stress not finite")
    A_lex = amg.assemble_csr(system)
    res10 = res  # phase 24 shards this run
    true_rel = true_rel_residual(system, A_lex, u)
    print(f"lex 55^3 box ({lex.ndof} DOFs, float64): GMG-CG iterations "
          f"{res.krylov_iters}, true rel residual {true_rel:.3e}, "
          f"stepper.run wall {wall:.2f} s, launches {launches_gmg}",
          flush=True)
    check(true_rel <= 1e-8, f"lex 55^3 true rel residual {true_rel}")
    check(launches_gmg["hex8_stiffness"] > 0, "the GMG run launched no K1")

    del system, u

    stamp("phase 11-13: cohesive")
    # 11. the cohesive decks on the card, against the CPU
    coh_deck = "examples/ref/cohesive_test_2.inp"
    fields = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cpu"):
            rc = cli_main(["-f", coh_deck, "--device", device, "-q",
                           "-o", f"{tmp}/{device}_"])
            check(rc == 0, f"CLI on {coh_deck} --device {device} exited {rc}")
            fields[device] = vtk.read_fields(
                f"{tmp}/{device}_0_output_000000.vtk")
    disp = fields["cuda"][2]
    check(np.allclose(disp[[6, 7], 1], 0.1, atol=1e-10),
          f"cohesive_test_2 u_y at nodes 7, 8: {disp[[6, 7], 1]}")
    for k, name in ((1, "stress"), (2, "u")):
        d = np.abs(fields["cuda"][k] - fields["cpu"][k]).max()
        check(d <= 1e-6, f"cohesive_test_2 VTK {name} cuda vs cpu: {d}")
    coh_p = problem_mod.load(coh_deck)
    r_coh = stepper.run(coh_p, Config(device="cuda"))
    check(r_coh.path == "cohesive_newton" and r_coh.nsteps == 2
          and r_coh.newton_iters[0] == 1,
          f"cohesive_test_2: path {r_coh.path}, Newton {r_coh.newton_iters}")
    print(f"cohesive_test_2 on cuda via the CLI: 2 steps, Newton iterations "
          f"{r_coh.newton_iters}, u_y 0.1 at nodes 7, 8, VTK equal to the "
          f"CPU run's (u and stress to 1e-6)", flush=True)
    czm = problem_mod.load("examples/czm_instability.inp")
    czm_cfg = dict(solver="direct", formulation="total", newton_maxit=100)
    r_czm = {d: stepper.run(czm, Config(device=d, **czm_cfg))
             for d in ("cuda", "cpu")}
    u_czm = r_czm["cuda"].aggregate_u.reshape(8, 2)
    gaps = [u_czm[1, 1] - u_czm[6, 1], u_czm[4, 1] - u_czm[7, 1]]
    s_czm = System(czm, torch.float64, device=dev)
    fy = s_czm.coh_force(torch.as_tensor(r_czm["cuda"].aggregate_u,
                                         device=dev)).cpu().numpy()[1::2]
    pair = (fy[6] + fy[7]) / 2.0
    abaqus = 0.0489376440 + 0.0131128022  # CZM_for_instability_test.log
    d_czm = np.abs(r_czm["cuda"].aggregate_u - r_czm["cpu"].aggregate_u).max()
    print(f"czm_instability total on cuda: Newton iterations "
          f"{r_czm['cuda'].newton_iters}, gaps {gaps[0]:.7f} "
          f"{gaps[1]:.7f}, per-node interface force {pair:.7f} (Abaqus "
          f"{abaqus:.7f}), max |u_cuda - u_cpu| {d_czm:.3e}", flush=True)
    check(all(r_czm["cuda"].newton_converged), "czm: Newton did not converge")
    check(np.allclose(gaps, 0.0999494, rtol=1e-4), f"czm gaps {gaps}")
    check(abs(pair / abaqus - 1.0) <= 2e-3, f"czm interface force {pair}")
    check(d_czm <= 1e-9 * np.abs(r_czm["cpu"].aggregate_u).max(),
          f"czm cuda vs cpu: {d_czm}")

    # the GMRES fallback on the card: tests/test_snapback.py's 8 x 4 strip
    # with its interface rigidly opened to 2 delta_n, past the traction
    # peak; at zeta 0.02 the tangent is indefinite and plain CG fails
    snap = meshgen.cohesive_interface_problem(
        8, 4, open_disp=0.004, t=1.0, dt=0.25, E=3640.0, nu=0.3,
        coh_props=(100.0, 0.001, 0.001, 1.0, 0.0, 0.02))
    snap_du = {}
    for d in ("cuda", "cpu"):
        s_snap = System(snap, torch.float64, device=d)
        agg = torch.zeros(s_snap.ndof, dtype=torch.float64, device=d)
        agg[torch.arange(45, 90, device=d) * 2 + 1] = 0.002
        du0 = torch.zeros_like(agg)
        F = s_snap.rhs(0.0)
        r_mf = newton.solve_step_matfree(
            s_snap, Config(device=d, solver="cg"), agg, du0, F)
        if d == "cuda":
            r_cg = newton.solve_step_matfree(
                s_snap, Config(device=d, solver="cg", inner_krylov="cg"),
                agg, du0, F)
            r_dense = newton.solve_step(
                s_snap, Config(device=d, solver="direct"), agg, du0, F,
                bc_mode="eliminate")
            print(f"snap-back 8 x 4 on cuda: matrix-free Newton iterations "
                  f"{r_mf.iters}, converged {r_mf.converged}, GMRES "
                  f"fallbacks {r_mf.gmres_fallbacks}, inner iterations "
                  f"{r_mf.inner_iters}; plain CG converged {r_cg.converged}"
                  f"; dense Newton iterations {r_dense.iters}", flush=True)
            check(r_mf.converged and r_mf.gmres_fallbacks >= 1,
                  "snap-back: the matrix-free Newton did not converge "
                  "through the GMRES fallback")
            check(r_dense.converged, "snap-back: the dense Newton failed")
            snap_du["dense"] = r_dense.du.cpu()
        snap_du[d] = r_mf.du.cpu()
    nd = float(torch.linalg.norm(snap_du["dense"]))
    d_dense = float(torch.linalg.norm(snap_du["cuda"] - snap_du["dense"])) / nd
    d_cpu = float(torch.linalg.norm(snap_du["cuda"] - snap_du["cpu"])) / nd
    print(f"snap-back: |du - du_dense| / |du_dense| {d_dense:.3e}, "
          f"|du_cuda - du_cpu| / |du_dense| {d_cpu:.3e} (tol 1e-5)",
          flush=True)
    check(d_dense <= 1e-5, f"snap-back cuda vs dense: {d_dense}")
    check(d_cpu <= 1e-5, f"snap-back cuda vs cpu: {d_cpu}")

    # 12. fem_tpu's cohesive benchmark strip, matrix-free on the card
    strip = meshgen.cohesive_interface_problem(
        360, 72, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015, t=1.0,
        dt=0.5, coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    check((strip.nnds, strip.ndof, strip.blocks["coh"].ne, strip.nsteps)
          == (52706, 105412, 360, 2), "the cohesive strip has the wrong size")

    def run_strip(problem, label):
        ck.reset_launches()
        msgs = []
        res, wall = sync_wall(torch, lambda: stepper.run(
            problem, Config(device="cuda", solver="cg"), log=msgs.append))
        launches_run = dict(ck.launches)
        for m in msgs:
            if "Interval" not in m:
                print(f"  stepper: {m.strip()}")
        print(f"{label} ({problem.ndof} DOFs, float64): Newton iterations "
              f"{res.newton_iters}, converged {res.newton_converged}, inner "
              f"iterations {res.krylov_iters}, GMRES fallbacks "
              f"{res.gmres_fallbacks}, stepper.run wall {wall:.2f} s, "
              f"launches {launches_run}", flush=True)
        check(res.path == "cohesive_newton", f"{label} took path {res.path}")
        check(all(res.newton_converged), f"{label}: Newton did not converge")
        u = res.aggregate_u.reshape(-1, 2)
        top = problem.coords[:, 1] == 2.0
        check(np.abs(u[top, 1] - 0.015).max() <= 1e-12,
              f"{label}: top edge u_y is not 0.015")
        check(np.isfinite(u).all() and np.isfinite(res.aggregate_stress).all()
              and res.aggregate_stress.shape == (problem.nnds, 3),
              f"{label}: u or stress not finite / wrong shape")
        return res, msgs, launches_run

    res12, msgs12, launches_strip = run_strip(strip,
                                              "cohesive strip, lattice GMG")
    check(any("lattice GMG" in m for m in msgs12),
          "the lex strip did not take the block stencil and lattice GMG")
    # the last step's Newton residual, recomputed from the assembled K_el
    # (torch sparse CSR on the card) and System.coh_force, against the
    # first residual of that step (at its warm start, the first increment)
    s_strip = System(strip, torch.float64, device=dev)
    A_csr = amg.assemble_csr(s_strip)
    K = torch.sparse_csr_tensor(
        torch.as_tensor(A_csr.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(A_csr.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(A_csr.data, dtype=torch.float64, device=dev),
        size=A_csr.shape, check_invariants=True)
    du_last = torch.as_tensor(res12.du, device=dev)
    agg_prev = torch.as_tensor(res12.aggregate_u, device=dev) - du_last
    mask = torch.zeros(strip.ndof, dtype=torch.bool, device=dev)
    mask[s_strip.bc_dofs] = True
    ubc = torch.zeros_like(du_last)
    ubc[s_strip.bc_dofs] = s_strip.bc_step_vals()
    F_last = s_strip.rhs(strip.dt)

    def newton_residual(du):
        r = ((K @ du.unsqueeze(1)).squeeze(1) - F_last
             - s_strip.coh_force(agg_prev + du))
        return float(torch.linalg.norm(torch.where(mask, du - ubc, r)))

    r_first = newton_residual(torch.where(mask, ubc, agg_prev))
    r_last = newton_residual(du_last)
    print(f"cohesive strip: last step's Newton residual recomputed from the "
          f"assembled CSR and coh_force {r_last:.3e}, first {r_first:.3e}, "
          f"ratio {r_last / r_first:.3e}", flush=True)
    check(r_last <= 1e-6 * r_first, "cohesive strip: recomputed residual")
    gap_n = coh_ops.gaps(s_strip.coh["ecoords"],
                         torch.as_tensor(res12.aggregate_u, device=dev)[
                             s_strip.coh["edofs"]], s_strip.dt)[0] / 0.01
    print(f"cohesive strip: interface normal gap {float(gap_n.min()):.4f} "
          f"to {float(gap_n.max()):.4f} delta_n (traction peak at 1)",
          flush=True)
    del K, A_csr, s_strip

    # 13. the node-permuted strip: fused operator and SA-AMG with K3
    pstrip = meshgen.permute_nodes(strip, seed=0)
    perm = np.random.default_rng(0).permutation(strip.nnds)
    check(np.array_equal(pstrip.coords, strip.coords[perm]),
          "permute_nodes did not use the expected permutation")
    res13, msgs13, launches_coh = run_strip(pstrip,
                                            "permuted cohesive strip, SA-AMG")
    check(any("SA-AMG" in m for m in msgs13),
          "the permuted strip did not take the fused operator and SA-AMG")
    check(launches_coh["csr_matvec"] > 0, "the SA-AMG Newton launched no K3")
    u_back = np.empty((strip.nnds, 2))
    u_back[perm] = res13.aggregate_u.reshape(-1, 2)
    rel = float(np.abs(u_back.reshape(-1) - res12.aggregate_u).max()
                / np.abs(res12.aggregate_u).max())
    print(f"permuted strip vs lex strip: max |du| / max |u| {rel:.3e}",
          flush=True)
    check(rel <= 1e-6, f"permuted strip u differs from the lex strip's: {rel}")
    # K3 on the tables that run used: the same hierarchy, rebuilt
    ops = newton.matfree_operators(System(pstrip, torch.float64, device=dev),
                                   Config(device="cuda", solver="cg"))
    check(ops.kind == "amg", f"the permuted strip's hierarchy is {ops.kind}")
    print(f"permuted strip hierarchy: level sizes {ops.mg.sizes}", flush=True)
    k3_hierarchy(ops.mg.hier, "strip")
    del ops

    stamp("phase 14-18: creep, resume, trace, gradients, native")
    # 14-15. creep on the card; checkpoint / resume of its 80^3 run
    with tempfile.TemporaryDirectory() as ck_dir:
        res14, saves, launches14, creep14 = phase14_creep(torch, dev, 80,
                                                          ck_dir)
        launches15 = phase15_resume(torch, 80, ck_dir, res14, saves, creep14)
    del res14, creep14
    # 16. phase timers and the torch.profiler trace
    phase16_trace(torch, 80)
    # 17. gradients through the kernels' autograd Functions
    runs_grad, summary_grad, k3_x_bar = phase17_gradients(
        torch, dev, k1_inputs, flush, amg55, mask55, csr_library)
    summary.update(summary_grad)
    del amg55, mask55
    # 18. the native parser
    phase18_native(cli_main)
    stamp("phase 19-20: CLI shards, warm start")
    # 19. --precond / --shards through the CLI
    phase19_cli_shards(cli_main, vtk)
    # 20. the warm start at 80^3
    launches_warm = phase20_warm(torch, dev, 80)
    stamp("phase 22: element-sharded")
    # 22. the element-sharded rows, 4 shards on this card
    (launches_shd_amg, launches_shd_coh, comm_element,
     sys_perm) = phase22_sharded(torch, dev, perm55, pstrip, res13,
                                 true_rel_residual)
    # 23-25. the DOF-sharded tiers, 4 shards on this card
    stamp("phase 23: slab stencil")
    (launches_slab4, launches_slab3, k2_slab,
     comm_psum) = phase23_slab(torch, dev, big, res7, k2_case,
                                    k2_measure)
    stamp("phase 24: halo block stencil")
    launches_halo_block, comm_block = phase24_halo_block(
        torch, dev, lex, res10, A_lex, true_rel_residual)
    del A_lex
    stamp("phase 25: halo-gather")
    launches_halo_gather, comm_gather = phase25_halo_gather(
        torch, dev, perm55, sys_perm, res9, A_perm, true_rel_residual)
    del A_perm, sys_perm
    stamp("phase 26: collectives by tier")
    # 26. the collectives of one K.u on every sharded tier (fem_tpu's
    # dryrun_multichip inventory), 4 shards
    from fem_tpu_torch.parallel import commcount
    for tier, comm in (
            ("element-sharded K.u (permuted 55^3)", comm_element),
            ("slab stencil matvec_sharded (80^3)", comm_psum),
            ("block-stencil halo_matvec_g (lex 55^3)", comm_block),
            ("halo-gather matvec (permuted 55^3)", comm_gather)):
        print(commcount.summary(tier, comm), flush=True)

    stamp("phase 27-30: the 2D structured row")
    # 27. K2's 2D branch against its plain forms, timed beside cuSPARSE
    summary["stencil_matvec_2d"] = phase27_k2_2d(torch, dev, flush,
                                                 csr_library)
    # 28. the 4,200,450-DOF quad cantilever through stepper.run
    res28, launches_quad, quad, quad_op, quad_rel = phase28_quad_box(torch,
                                                                     dev)
    # 29. the reference's make_example strip through the CLI
    launches_strip2d = phase29_strip_cli(torch, dev, cli_main, vtk)
    # 30. the 2D slab-sharded row, 4 and 3 shards on this card
    launches_slab2d4, launches_slab2d3 = phase30_slab_2d(
        torch, dev, quad, quad_op, quad_rel, res28)
    del quad, quad_op, quad_rel
    stamp("phase 31: plane stress on the stencil rows, the 3D decks")
    # 31. phase 28's box under plane stress, 1 and 4 shards; the 3D decks
    launches_ps, launches_ps4, launches_decks = phase31_plane_stress(
        torch, dev, res28)
    del res28

    summary["csr_matvec"] = k3_real
    # each path's own launches, each counted from 0 just before its run
    runs = {"direct_6": {"hex8_stiffness": k1_direct},
            "elastic_80": launches, "amg_55": launches_amg,
            "gmg_55": launches_gmg, "coh_strip_gmg": launches_strip,
            "coh_strip_amg": launches_coh, "creep_80": launches14,
            "resume_80": launches15, **runs_grad,
            "warm_3step_80": launches_warm,
            "sharded_amg_plate": launches_shd_amg,
            "sharded_coh_strip_amg": launches_shd_coh,
            "sharded_slab_80": launches_slab4,
            "sharded_slab_80_3shards": launches_slab3,
            "sharded_halo_block_55": launches_halo_block,
            "sharded_halo_gather_55": launches_halo_gather,
            "quad_box_2d": launches_quad, "quad_strip_cli": launches_strip2d,
            "sharded_slab_quad_2d": launches_slab2d4,
            "sharded_slab_quad_2d_3shards": launches_slab2d3,
            "quad_box_2d_plane_stress": launches_ps,
            "sharded_slab_quad_2d_plane_stress": launches_ps4,
            "decks_3d": launches_decks}
    # "launches" is the count of the kernel's main path: the 80^3 elastic
    # run for K1 and K2, the 2D quad box's run for K2's 2D branch, the 55^3
    # SA-AMG run for K3, the 6^3 compliance gradient in the coordinates for
    # K1's coordinate backward and the gradient through the 55^3 V-cycle
    # for K3's backward in data
    main_path = {"hex8_stiffness": "elastic_80",
                 "hex8_stiffness_coord_grad": "grad_coords_6",
                 "stencil_matvec": "elastic_80",
                 "stencil_matvec_2d": "quad_box_2d", "csr_matvec": "amg_55",
                 "csr_data_grad": "grad_vcycle_55"}
    sources = {
        "hex8_stiffness": ("fem_tpu_torch/csrc/hex8_stiffness.cu",
                           "fem_tpu/ops/pallas_kernels.py:352"),
        "stencil_matvec": ("fem_tpu_torch/csrc/stencil_matvec.cu",
                           "fem_tpu/ops/pallas_kernels.py:302"),
        # K2's function on 2D grids, which the Pallas kernel does not cover
        "stencil_matvec_2d": ("fem_tpu_torch/csrc/stencil_matvec.cu",
                              "fem_tpu/ops/pallas_kernels.py:302"),
        "csr_matvec": ("fem_tpu_torch/csrc/csr_matvec.cu",
                       "fem_tpu/ops/pallas_kernels.py:432"),
        # the backward kernels of K1 and K3, whose Pallas kernels have none
        "hex8_stiffness_coord_grad": ("fem_tpu_torch/csrc/hex8_stiffness.cu",
                                      "fem_tpu/ops/pallas_kernels.py:352"),
        "csr_data_grad": ("fem_tpu_torch/csrc/csr_matvec.cu",
                          "fem_tpu/ops/pallas_kernels.py:432"),
    }
    # once more, beside the numbers: a reader of the end of a long log
    # still learns the card and its power limit
    print(f"card: {smi}", flush=True)
    print("K2 on one slab of the 4-shard 80^3 run: " + json.dumps(k2_slab),
          flush=True)
    print("K3's backward in x (K3 on the transposed 55^3 level-0 tables), "
          "float64: " + json.dumps(k3_x_bar), flush=True)
    print("K2's 2D branch on the quad box's grid, float64: "
          + json.dumps(summary["stencil_matvec_2d"]), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": runs[main_path[name]][name],
         "launches_path": main_path[name],
         "launches_by_path": {path: run.get(name, 0)
                              for path, run in runs.items()},
         **{key: summary[name][key] for key in (
             "max_abs_err", "ms", "back_to_back_ms", "cold_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_back_to_back_ms",
             "library_cold_ms")}}
        for name, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
