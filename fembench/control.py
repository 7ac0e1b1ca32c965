"""The control of the comparison that decides `correct`, and the program's
readings beside it, on the card at a cell's own size:

    python3 fembench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control <how many of them also run the control; 3>]

For each seed it draws the window's first deck as a run does, runs it
through the program (the timed path's entry) and puts the reference in the
program's place computed one precision below the configuration's (float32
for float64, TF32 off). With `--loose <rtol>` the same seeds also run the
program with its solves stopped at that looser tolerance: the fault of a
solve that gives up the configuration's accuracy. All are judged against
the float64 reference; one JSON line per seed gives the program's numbers,
the control's and the loose program's. A limit lies between the program's
largest reading and the least of the others that fail it. The benchmark's
own runs do not run this.
"""

import argparse
import copy
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fembench import reference  # noqa: E402
from fembench.harness import spec  # noqa: E402


def loosened(cell, rtol: float):
    """The cell with its program's solves stopped at `rtol`."""
    out = copy.deepcopy(cell)
    out.config["guarantee"]["rtol"] = rtol
    return out


def _program(cell, seed: int, device: str, log) -> dict:
    """The program's numbers on the first deck of `seed`, and the entry."""
    entry = cell.entry_class()(cell, seed, device, False)
    entry.log = log
    inputs = entry.next_deck()
    out = entry.run_deck(inputs, 0, {})
    kept = entry.kept(inputs, out)
    entry.release()
    return entry, kept


def readings(cell, seed: int, device: str, control: bool = True,
             log=lambda m: None, loose: float = None) -> dict:
    """{'program': {...}, 'control': {...}, 'loose': {...}} on the first deck
    of `seed`; without `control` and `loose` the program's alone."""
    import torch

    entry, kept = _program(cell, seed, device, log)
    t0 = time.perf_counter()
    try:
        program = entry.compare([kept])
        t1 = time.perf_counter()
        ctl = entry.compare([kept], solve=lambda deck: reference.run(
            deck, torch.float32, device)) if control else None
    finally:
        entry.close()
    t2 = time.perf_counter()
    lax = None
    if loose is not None:
        entry, kept = _program(loosened(cell, loose), seed, device, log)
        try:
            lax = entry.compare([kept])
        finally:
            entry.close()
    return dict(seed=seed, program=program, control=ctl, loose=lax,
                loose_rtol=loose, reference_s=t1 - t0, control_s=t2 - t1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds, the first, also run the "
                         "control")
    ap.add_argument("--loose", type=float, default=None,
                    help="also run the program with its solves stopped at "
                         "this relative tolerance, on the seeds that run "
                         "the control")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        first = i < args.control
        print(json.dumps(readings(cell, seed, "cuda", first,
                                  lambda m: print(m, file=sys.stderr),
                                  args.loose if first else None)),
              flush=True)


if __name__ == "__main__":
    main()
