"""Phase times and a device profile of fem_tpu_torch's iterative solves.

    python tools/torch_profile_solve.py [--n 80] [--reps 3] [--trace PATH]
    python tools/torch_profile_solve.py --amg [--n 55] [--reps 1]

Default: the structured MG-CG path of stepper.run on the n^3-cell hex8 box
(n = 80: 1,594,323 DOFs). With --amg: the unstructured path's SA-AMG branch
on the node-permuted, jittered n^3 box (n = 55: 526,848 DOFs, the box of
bench.bench_amg_solve); its set-up is split into assemble_csr, fused
operator and hierarchy build (the stepper's own log line), and the fine
matvec is timed as the fused operator against kernel K3 on the assembled
matrix in ELL form. float64 throughout, on the CUDA card.

Each phase is timed on the host clock around a synchronize, after one
warm-up pass that builds the kernels. Every phase then runs once more under
torch.profiler for its device time; for the solve the kernels per CG
iteration, the device-busy share and the table of device time by kernel are
printed, and with --trace the solve's Chrome trace is written to PATH.
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
    """Run fn under torch.profiler: (wall s, device-busy ms, kernel count,
    the profiler's key averages)."""
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


def structured_phases(n, dev, config, log):
    problem = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0)
    print(f"structured MG-CG: {n}^3 cells, {problem.ndof} DOFs, float64")
    st = {}
    return problem, [
        ("detect", lambda: st.update(spec=structured.detect(problem))),
        ("system", lambda: st.update(system=System(problem, torch.float64,
                                                   device=dev))),
        ("op+mg build", lambda: st.update(solve=stepper._setup_structured(
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
            solve=stepper._setup_unstructured(st["system"], config, "cg",
                                              None, log))),
    ], st


def fine_matvec_pair(system, reps):
    """The fine operator two ways on the same vector: the fused operator
    (the path's) and K3 on the assembled, BC-eliminated matrix in ELL."""
    bc = system.bc_dofs
    mask = torch.zeros(system.ndof, dtype=torch.bool, device=system.device)
    mask[bc] = True
    fop = operator.build(system)
    fused = cg.masked_operator(lambda v: operator.matvec(fop, v), mask)
    A = amg._eliminate_bcs(amg.assemble_csr(system), bc.cpu().numpy())
    ell = amg.Ell.from_csr(A, torch.float64, system.device)
    x = torch.randn(system.ndof, dtype=torch.float64, device=system.device)
    diff = float(torch.linalg.norm(fused(x) - ell(x)) / torch.linalg.norm(
        ell(x)))
    w, rows = ell.vals.shape
    print(f"fine matvec, {rows} rows: fused operator "
          f"{event_ms(lambda: fused(x), reps):.4f} ms, K3 on the assembled "
          f"ELL (w {w}, {A.nnz} nonzeros, {ell.vals.numel() / A.nnz:.3f} "
          f"slots per nonzero) {event_ms(lambda: ell(x), reps):.4f} ms; "
          f"rel diff {diff:.2e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--amg", action="store_true",
                    help="the unstructured SA-AMG path on the permuted box")
    ap.add_argument("--n", type=int, default=None,
                    help="cells per axis (default 80, or 55 with --amg)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed passes (default 3, or 1 with --amg)")
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    n = args.n or (55 if args.amg else 80)
    reps = args.reps or (1 if args.amg else 3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    config = Config(device="cuda")
    msgs = []
    problem, setup, st = (amg_phases if args.amg else structured_phases)(
        n, dev, config, msgs.append)
    phases = setup + [
        ("rhs", lambda: st.update(F=st["system"].rhs(0.0))),
        ("solve", lambda: st.update(out=st["solve"](
            st["F"], st["system"].bc_step_vals(), torch.zeros_like(st["F"])))),
        ("stress", lambda: st["system"].stress_increment(st["out"][0])),
    ]

    times = {}
    for rep in range(reps + 1):  # rep 0 builds the kernels: not kept
        cuda_kernels.reset_launches()
        msgs.clear()
        for name, fn in phases:
            _, t = sync_time(fn)
            if rep:
                times.setdefault(name, []).append(t)
    iters = st["out"][1]
    print(f"CG iterations {iters}, launches per pass "
          f"{dict(cuda_kernels.launches)}")
    for m in msgs:
        if "set-up" in m:
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
    print(f"profiled solve: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_ms:.2f} ms ({100 * dev_ms / 1e3 / wall:.1f}%), {kernels} "
          f"kernels, {kernels / max(iters, 1):.1f} per CG iteration")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    if args.amg:
        fine_matvec_pair(st["system"], 20)
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
