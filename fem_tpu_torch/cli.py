"""Command-line driver: `python -m fem_tpu_torch -f <deck.inp> [--device cpu]`.

Port of `fem_tpu/cli.py`. Mirrors the reference CLI
`mpiexec -n <cores> defmod -f <file>` (main.F90:31-33): `--devices N` shards
the iterative solve over N devices by the tier that fits the deck
(solver/stepper.py), `--shards N` writes one `<rank>_output_000000.vtk` per RCB
shard like the reference's per-rank writers; otherwise `0_output_000000.vtk`
is written in the working directory like the reference's rank-0 writer
(m_io.F90:496). Runs on the CUDA device by default; `--device cpu` asks for
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fem_tpu_torch",
        description="PyTorch/CUDA FEM solver (defmod-compatible decks)",
    )
    ap.add_argument("-f", dest="input_file", help="input .inp deck")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument(
        "--solver", default="auto", choices=["auto", "direct", "cg"],
        help="linear solver (default: auto)"
    )
    ap.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ap.add_argument(
        "--precond", default="auto", choices=["auto", "jacobi", "amg"],
        help="preconditioner for the iterative unstructured path "
        "(auto: AMG at scale)",
    )
    ap.add_argument(
        "--bc-mode", default="auto", choices=["auto", "penalty", "eliminate"]
    )
    ap.add_argument("--plane-stress", action="store_true",
                    help="treat 2D elements as plane stress (the reference "
                         "is plane strain only)")
    ap.add_argument("--quirks", action="store_true",
                    help="replicate reference cohesive defects bit-for-bit")
    ap.add_argument("--formulation", default="auto",
                    choices=["reference", "standard", "total", "auto"],
                    help="cohesive residual (default: auto): reference, "
                         "the incremental standard, or total (true "
                         "equilibrium each step; dense under the direct "
                         "solver, matrix-free under cg)")
    ap.add_argument("-o", "--output-prefix", default="",
                    help="directory/prefix for VTK output")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write per-step resume checkpoints here")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints in --checkpoint-dir")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace (Chrome trace "
                         "JSON) of the run here")
    ap.add_argument("--timing", action="store_true",
                    help="print per-phase wall-clock totals after the run")
    ap.add_argument("--parser", default="auto",
                    choices=["auto", "python", "native"],
                    help="deck parser backend")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the iterative linear solve over N devices "
                         "(the reference's mpiexec -n N; 0 = single device)")
    ap.add_argument("--shards", type=int, default=1,
                    help="write N per-shard VTK files (RCB partition), "
                         "mirroring the reference's per-MPI-rank output")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if not args.input_file:
        print("Usage: python -m fem_tpu_torch -f <filename>")
        return 1

    def log(msg: str) -> None:
        if not args.quiet:
            print(msg, flush=True)

    from fem_tpu_torch.config import Config
    from fem_tpu_torch.io import vtk
    from fem_tpu_torch.models import problem as problem_mod
    from fem_tpu_torch.solver import stepper

    log("Reading input ...")
    if not os.path.exists(args.input_file):
        print(f"error: input file not found: {args.input_file}",
              file=sys.stderr)
        return 1
    try:
        problem = problem_mod.load(args.input_file, backend=args.parser)
    except (ValueError, NotImplementedError) as e:
        print(f"error: cannot parse {args.input_file}: {e}", file=sys.stderr)
        return 1
    config = Config(
        device=args.device,
        dtype=args.dtype,
        solver=args.solver,
        bc_mode=args.bc_mode,
        precond=args.precond,
        plane_stress=args.plane_stress,
        quirks=args.quirks,
        formulation=args.formulation,
        checkpoint_dir=args.checkpoint_dir,
        resume=not args.no_resume,
        profile_dir=args.profile_dir,
        n_devices=args.devices if args.devices > 1 else None,
        timing=args.timing,
    )
    log("Forming [K] ...")
    t0 = time.perf_counter()
    result = stepper.run(problem, config, log=log)
    log(f"Solved {result.nsteps} step(s) in {time.perf_counter() - t0:.3f}s")
    if args.shards > 1:
        from fem_tpu_torch.parallel import partition

        partition.write_sharded_vtk(
            problem, result.aggregate_stress, result.aggregate_u,
            args.shards, prefix=args.output_prefix)
    else:
        vtk.write(
            f"{args.output_prefix}0_output_000000.vtk",
            problem.coords,
            vtk.cells_in_deck_order(problem),
            result.aggregate_stress,
            result.aggregate_u,
        )
    log("Finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
