"""Phase times and a device profile of fem_tpu_torch's iterative solves.

    python tools/torch_profile_solve.py [--n 80] [--reps 3] [--trace PATH]
    python tools/torch_profile_solve.py --amg [--n 55] [--reps 1]
    python tools/torch_profile_solve.py --coh [--n 360] [--reps 1]
    python tools/torch_profile_solve.py --creep [--n 80] [--reps 3]
    python tools/torch_profile_solve.py --quad [--n 1024] [--reps 1]

Default: the structured MG-CG path of stepper.run on the n^3-cell hex8 box
(n = 80: 1,594,323 DOFs). With --amg: the unstructured path's SA-AMG branch
on the node-permuted, jittered n^3 box (n = 55: 526,848 DOFs, the box of
bench.bench_amg_solve); its set-up is split into assemble_csr, fused
operator and hierarchy build (the stepper's own log line), and the fine
matvec is timed as the fused operator against kernel K3 on the assembled
matrix in CSR form. With --coh: the cohesive Newton path on fem_tpu's
benchmark strip (cohesive_interface_problem(n, n // 5), lx = 5; n = 360:
105,412 DOFs), matrix-free Newton-Krylov with the block stencil and lattice
GMG; the profiled "solve" is the first load step's Newton solve, from zero, to
u_y = 0.0075 on the top edge. With --creep: one viscoelastic load step of
the n^3 box through the structured MG-CG path (visc 10 G, tau = 10 steps,
expn 1), split into the creep moduli (D_eff = (S + dt beta')^-1, the batched
6x6 inverses), the RHS with the creep force, the solve, the creep stress
update and its nodal average; each timed pass rebuilds the set-up, so it
starts from a zero creep state (the work does not depend on the state's
values). With --quad: the structured MG-CG path on the clamped 2D
cantilever meshgen.quad_grid_problem(2n, n, lx=2, ly=1) with a tip force
(n = 1024: 2,097,152 quads, 4,200,450 DOFs), and the wall of a whole
stepper.run of it. float64 throughout, on the CUDA card.

Each phase is timed on the host clock around a synchronize, after one
warm-up pass that builds the kernels. Every phase then runs once more under
torch.profiler for its device time; for the solve the kernels per CG
iteration, the host-side stream synchronizations and host-to-device copies
per CG iteration, the device-busy share and the table of device time by
kernel are printed, and with --trace the solve's Chrome trace is written to
PATH. With --creep a whole step is profiled once more: its device-busy
share, its top device ops, and the device time of the batched inverses and
of the creep force's scatter.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fem_tpu_torch.config import Config  # noqa: E402
from fem_tpu_torch.io import meshgen  # noqa: E402
from fem_tpu_torch.models.system import System  # noqa: E402
from fem_tpu_torch.ops import cuda_kernels, operator, structured  # noqa: E402
from fem_tpu_torch.solver import amg, cg, stepper  # noqa: E402


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps=20):
    """Median CUDA-event time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn):
    """Run fn under torch.profiler: (wall s, device-busy ms, count of device
    events (kernels and copies), the profiler's key averages)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(fn)
    events = prof.key_averages()
    # device-side rows only: the aten:: rows repeat their kernels' time
    dev_rows = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in dev_rows) / 1e3
    return wall, dev_ms, sum(e.count for e in dev_rows), prof


def host_syncs(prof):
    """Counts of the CUDA runtime calls that stop the host (stream and
    device synchronizations), of the device's copies and sets, and of the
    host-to-device copies among them, from the profiler's host-side and
    device-side rows."""
    counts = {"synchronize": 0, "memcpy HtoD": 0, "copies": 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key.startswith(("Memcpy", "Memset")):
                counts["copies"] += e.count
            if e.key.startswith("Memcpy HtoD"):
                counts["memcpy HtoD"] += e.count
        elif e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            counts["synchronize"] += e.count
    return counts


def structured_phases(n, dev, config, log, quad=False):
    if quad:
        problem = meshgen.quad_grid_problem(2 * n, n, lx=2.0, ly=1.0,
                                            tip_force=(0.0, -1e6))
        print(f"structured MG-CG: {2 * n} x {n} quads, {problem.ndof} DOFs, "
              f"float64")
    else:
        problem = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0)
        print(f"structured MG-CG: {n}^3 cells, {problem.ndof} DOFs, float64")
    st = {}
    return problem, [
        ("detect", lambda: st.update(spec=structured.detect(problem))),
        ("system", lambda: st.update(system=System(problem, torch.float64,
                                                   device=dev))),
        ("op+mg build", lambda: st.update(step=stepper._setup_structured(
            st["system"], config, "cg", st["spec"], log))),
    ], st


def amg_phases(n, dev, config, log):
    problem = meshgen.permute_nodes(meshgen.hex_box_problem(
        n, n, n, lx=1.0, ly=1.0, lz=1.0, E=200e9, nu=0.3, tip_load=-1e6,
        jitter=0.25, seed=0), seed=0)
    print(f"unstructured SA-AMG-CG: permuted, jittered {n}^3 cells, "
          f"{problem.ndof} DOFs, float64")
    st = {}
    return problem, [
        ("system", lambda: st.update(system=System(problem, torch.float64,
                                                   device=dev))),
        ("unstructured set-up", lambda: st.update(
            step=stepper._setup_unstructured(st["system"], config, "cg",
                                             None, log))),
    ], st


def coh_phases(n, dev, config, log):
    problem = meshgen.cohesive_interface_problem(
        n, n // 5, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015, t=1.0,
        dt=0.5, coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    print(f"cohesive Newton-Krylov: {n} x {n // 5} x 2 quads, "
          f"{problem.blocks['coh'].ne} cohesive elements, {problem.ndof} DOFs, "
          f"float64")
    st = {}
    return problem, [
        ("system", lambda: st.update(system=System(problem, torch.float64,
                                                   device=dev))),
        ("newton set-up", lambda: st.update(step=stepper._setup_cohesive(
            st["system"], config, "cg", None, log))),
    ], st


def creep_phases(n, dev, config, log):
    problem = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                      t=4.0, dt=1.0)
    problem.mats = problem.mats.copy()
    problem.mats[:, 2] = 10.0 * problem.mats[0, 0] / (2.0 * (
        1.0 + problem.mats[0, 1]))
    print(f"viscoelastic structured MG-CG: {n}^3 cells, {problem.ndof} DOFs, "
          f"creep state {problem.nels} x 8 x 6, float64")
    st = {}

    def creep_rhs():
        system = st["system"]
        st.update(F=system.rhs(0.0) + system.creep_force(st["state"],
                                                         st["moduli"]))

    def creep_update():
        st.update(state=st["system"].creep_stress_update(
            st["state"], st["out"].du, st["moduli"]))

    setup = [
        ("detect", lambda: st.update(spec=structured.detect(problem))),
        ("system", lambda: st.update(system=System(problem, torch.float64,
                                                   device=dev))),
        ("op+mg build", lambda: st.update(step=stepper._setup_structured(
            st["system"], config, "cg", st["spec"], log))),
        ("creep state", lambda: st.update(
            state=st["system"].creep_state_init())),
    ]
    step = [
        ("creep moduli", lambda: st.update(
            moduli=st["system"].creep_moduli(st["state"]))),
        ("rhs + creep force", creep_rhs),
        ("solve", None),
        ("creep update", creep_update),
        ("nodal average", lambda: st["system"].nodal_average_state(
            st["state"])),
    ]
    return problem, setup, st, step


def creep_step_profile(phases):
    """One more creep step under torch.profiler: device-busy share, top
    device ops, and the device time of the inverses and the scatters."""
    step = [fn for name, fn in phases if name in (
        "creep moduli", "rhs + creep force", "solve", "creep update",
        "nodal average")]
    wall, dev_ms, kernels, prof = device_profile(
        lambda: [fn() for fn in step])
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def device_ms(*keys):
        return sum(e.self_device_time_total for e in rows
                   if any(k in e.key.lower() for k in keys)) / 1e3

    print(f"profiled creep step: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_ms:.2f} ms ({100 * dev_ms / 1e3 / wall:.1f}%), {kernels} "
          f"kernels; batched inverses (cuBLAS getrf / getri / trsm batch "
          f"kernels) {device_ms('getrf', 'getri', 'trsm'):.2f} "
          f"ms, index_add / scatter kernels "
          f"{device_ms('index', 'scatter'):.2f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))


def fine_matvec_pair(system, reps):
    """The fine operator two ways on the same vector: the fused operator
    (the path's) and K3 on the assembled, BC-eliminated matrix in CSR."""
    bc = system.bc_dofs
    mask = torch.zeros(system.ndof, dtype=torch.bool, device=system.device)
    mask[bc] = True
    fop = operator.build(system)
    fused = cg.masked_operator(lambda v: operator.matvec(fop, v), mask)
    A = amg._eliminate_bcs(amg.assemble_csr(system), bc.cpu().numpy())
    csr = amg.Csr.from_csr(A, torch.float64, system.device)
    x = torch.randn(system.ndof, dtype=torch.float64, device=system.device)
    diff = float(torch.linalg.norm(fused(x) - csr(x)) / torch.linalg.norm(
        csr(x)))
    print(f"fine matvec, {A.shape[0]} rows: fused operator "
          f"{event_ms(lambda: fused(x), reps):.4f} ms, K3 on the assembled "
          f"CSR ({A.nnz} nonzeros, {csr.lanes} lanes per row) "
          f"{event_ms(lambda: csr(x), reps):.4f} ms; rel diff {diff:.2e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--amg", action="store_true",
                    help="the unstructured SA-AMG path on the permuted box")
    ap.add_argument("--coh", action="store_true",
                    help="the cohesive Newton path on the benchmark strip")
    ap.add_argument("--creep", action="store_true",
                    help="one viscoelastic step of the structured box")
    ap.add_argument("--quad", action="store_true",
                    help="the structured path on the 2n x n quad cantilever")
    ap.add_argument("--n", type=int, default=None,
                    help="cells per axis (default 80, 55 with --amg, 360 "
                         "along the strip with --coh, 1024 across the quad "
                         "cantilever with --quad)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed passes (default 3, or 1 with --amg, --coh "
                         "or --quad)")
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    n = args.n or (55 if args.amg else 360 if args.coh else 1024 if
                   args.quad else 80)
    reps = args.reps or (1 if args.amg or args.coh or args.quad else 3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    config = Config(device="cuda", solver="cg" if args.coh else "auto")
    msgs = []

    def solve():
        F = st["F"]
        st.update(out=st["step"](F, torch.zeros_like(F), torch.zeros_like(F),
                                 problem.dt))

    if args.creep:
        problem, setup, st, step = creep_phases(n, dev, config, msgs.append)
        step = [(name, fn or solve) for name, fn in step]
    else:
        if args.amg or args.coh:
            problem, setup, st = (amg_phases if args.amg else coh_phases)(
                n, dev, config, msgs.append)
        else:
            problem, setup, st = structured_phases(n, dev, config,
                                                   msgs.append, args.quad)
        step = [
            ("rhs", lambda: st.update(F=st["system"].rhs(0.0))),
            ("solve", solve),
            ("stress", lambda: st["system"].stress_increment(st["out"].du)),
        ]
    phases = setup + step

    times = {}
    for rep in range(reps + 1):  # rep 0 builds the kernels: not kept
        cuda_kernels.reset_launches()
        msgs.clear()
        for name, fn in phases:
            _, t = sync_time(fn)
            if rep:
                times.setdefault(name, []).append(t)
    iters = st["out"].iters
    if args.coh:
        r = st["out"].newton
        print(f"Newton iterations {r.iters} (converged {r.converged}), inner "
              f"CG iterations {iters}, GMRES fallbacks {r.gmres_fallbacks}")
    print(f"CG iterations {iters}, launches per pass "
          f"{dict(cuda_kernels.launches)}")
    for m in msgs:
        if "set-up" in m or "wall" in m:
            print(f"  stepper: {m.strip()}")
    device_ms = {}
    for name, fn in phases:
        if name == "solve":
            wall, dev_ms, kernels, prof = device_profile(fn)
            device_ms[name] = dev_ms
        else:
            device_ms[name] = device_profile(fn)[1]
    for name, v in times.items():
        print(f"  {name:20s} host median {statistics.median(v) * 1e3:10.2f} ms"
              f"  device {device_ms[name]:9.2f} ms  runs "
              f"{[round(x * 1e3, 2) for x in v]}")
    syncs = host_syncs(prof)
    print(f"profiled solve: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_ms:.2f} ms ({100 * dev_ms / 1e3 / wall:.1f}%), {kernels} "
          f"device events, {kernels / max(iters, 1):.1f} per CG iteration "
          f"({kernels - syncs['copies']} kernels, "
          f"{(kernels - syncs['copies']) / max(iters, 1):.1f} per CG "
          f"iteration); "
          f"stream synchronizations {syncs['synchronize']} "
          f"({syncs['synchronize'] / max(iters, 1):.1f} per CG iteration), "
          f"host-to-device copies {syncs['memcpy HtoD']} "
          f"({syncs['memcpy HtoD'] / max(iters, 1):.1f} per CG iteration)")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    if args.amg:
        fine_matvec_pair(st["system"], 20)
    if args.creep:
        torch.cuda.reset_peak_memory_stats()
        creep_step_profile(phases)
        print(f"peak device memory of the profiled step "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if args.quad:
        cuda_kernels.reset_launches()
        res, t = sync_time(lambda: stepper.run(problem, config))
        print(f"stepper.run: wall {t:.3f} s, path {res.path}, MG-CG "
              f"iterations {res.krylov_iters}, launches "
              f"{dict(cuda_kernels.launches)}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
