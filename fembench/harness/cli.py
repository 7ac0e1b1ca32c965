"""The command line of one run of one cell:

    python fembench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the run's result as the last line of its standard output, one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, with --trace 1 breakdown, and
last `checks`, each number compared with its limit; the same numbers are the
last lines of its standard error. Without the CUDA cards that the cell asks
for, or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from fembench.harness import compare, loop, spec

BANNED = {"jax", "jaxlib", "flax", "fem_tpu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float):
    """(result, checks) of one run, or (None, reason) where no result may
    be printed."""
    import torch

    record = loop.run(cell, seed, seconds, trace, device, t_start, log)
    found = banned_modules()
    if found:
        return None, f"modules of JAX or the JAX package loaded: {found}"
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, rows = compare.judge(record["values"], cell.limits)
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": record["peak_bytes"]}
    prof, kua = record["profile"], record["kua"]
    if trace and prof:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    if kua and kua.get("power_limit_w") is not None:
        dev["power_limit_w"] = kua["power_limit_w"]
    result = {"correct": bool(ok and record["failed"] == 0
                              and record["attempted"] > 0),
              "attempted": record["attempted"], "failed": record["failed"],
              "metrics": metrics, "device": dev}
    if trace and prof:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="fembench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"fembench: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count = {have}. No result.")
        return 3
    result, rows = execute(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start)
    if result is None:
        log(f"fembench: {rows}. No result.")
        return 4
    for name, value, limit in rows:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
