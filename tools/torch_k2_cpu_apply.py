"""Peak memory and time of one K.u of the structured operator on the CPU.

    python tools/torch_k2_cpu_apply.py [--n 81] [--reps 3]

On CPU tensors the K2 wrapper (cuda_kernels.stencil_matvec) returns its
plain form, stencil27_plain; the 2D operator and the checks use the
per-corner masked form, stencil_matvec_plain. Each form runs in a child
process of its own on the n^3 node grid (float64), after the operator and u
are built: the line it prints gives the growth of the process's peak
resident set over its first apply (what that apply allocates above what
was held before it) and the median wall time of `--reps` applies.
"""

import argparse
import os
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fem_tpu_torch.ops import cuda_kernels, structured  # noqa: E402

FORMS = {
    "stencil27_plain": lambda op, u: cuda_kernels.stencil27_plain(
        op.tables, u),
    "stencil_matvec_plain": lambda op, u: cuda_kernels.stencil_matvec_plain(
        op.k_ref, u, op.shape),
}


def run_form(form, n, reps):
    torch.set_num_threads(1)
    op = structured.build((1.0 / (n - 1),) * 3, (n, n, n), 1.0, 1.0,
                          device="cpu")
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(op.ndof))
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    FORMS[form](op, u)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        FORMS[form](op, u)
        times.append(time.perf_counter() - t0)
    print(f"{form} on {n}^3 nodes (u {u.numel() * 8 / 2**20:.2f} MiB): peak "
          f"resident set grown by {grown / 1024:.1f} MiB over the first "
          f"apply; median apply {statistics.median(times) * 1e3:.1f} ms "
          f"over {reps}, one thread", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=81, help="nodes per axis")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--form", choices=sorted(FORMS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.form:
        run_form(args.form, args.n, args.reps)
        return
    for form in FORMS:
        subprocess.run([sys.executable, __file__, "--n", str(args.n),
                        "--reps", str(args.reps), "--form", form], check=True)


if __name__ == "__main__":
    main()
