"""Phase times and a device profile of fem_tpu_torch's structured solve.

    python tools/torch_profile_solve.py [--n 80] [--reps 3] [--trace PATH]

Runs the structured MG-CG path of stepper.run on the n^3-cell hex8 box
(n = 80: 1,594,323 DOFs, float64) on the CUDA card, phase by phase:
detection, System set-up, operator + multigrid build, RHS, solve, stress
recovery. Each phase is timed on the host clock around a synchronize, after
one warm-up pass that builds the kernels. The solve then runs once more
under torch.profiler: the device-busy share and the table of device time by
kernel are printed, and with --trace the Chrome trace is written to PATH.
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
from fem_tpu_torch.ops import cuda_kernels, structured  # noqa: E402
from fem_tpu_torch.solver import stepper  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=80)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    config = Config(device="cuda")
    problem = meshgen.hex_box_problem(args.n, args.n, args.n, lx=1.0, ly=1.0,
                                      lz=1.0)
    print(f"{args.n}^3 cells, {problem.ndof} DOFs, float64")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    times = {}
    for rep in range(args.reps + 1):  # rep 0 builds the kernels: not kept
        cuda_kernels.reset_launches()
        spec, t_detect = timed(lambda: structured.detect(problem))
        system, t_sys = timed(lambda: System(problem, torch.float64,
                                             device=dev))
        solve, t_setup = timed(lambda: stepper._setup_structured(
            system, config, "cg", spec, lambda m: None))
        F, t_rhs = timed(lambda: system.rhs(0.0))
        zero = torch.zeros_like(F)
        (du, iters), t_solve = timed(
            lambda: solve(F, system.bc_step_vals(), zero))
        _, t_stress = timed(lambda: system.stress_increment(du))
        if rep:
            for k, v in (("detect", t_detect), ("system", t_sys),
                         ("op+mg build", t_setup), ("rhs", t_rhs),
                         ("solve", t_solve), ("stress", t_stress)):
                times.setdefault(k, []).append(v)
    print(f"MG-CG iterations {iters}, K2 launches per solve+build "
          f"{cuda_kernels.launches['stencil_matvec']}")
    for k, v in times.items():
        print(f"  {k:12s} median {statistics.median(v) * 1e3:9.2f} ms  "
              f"runs {[round(x * 1e3, 2) for x in v]}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: solve(F, system.bc_step_vals(), zero))
    events = prof.key_averages()
    # device-side rows only: the aten:: rows repeat their kernels' time
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled solve: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e6 / wall:.1f}%)")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
