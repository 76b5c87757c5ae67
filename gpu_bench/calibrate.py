"""The readings a cell's comparison limits (``limits/<cell>.json``) are set
from, in one process: for each seed, one analysis of the cell through its
entry point, checked as a run checks the analysis it keeps (the program's
readings); for the first ``--control`` seeds, the same check with the plain
reference, in the precision below the configuration's (``check.CONTROL``),
in the program's place (the control's readings). A benchmark run does not
run this.

    python3 -m gpu_bench.calibrate --workload <cell> --seeds 11,12,13 --control 3 \\
        [--out readings.jsonl]

Each reading is one JSON line, on standard output and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["readings", "main"]


def readings(cell, bench, seeds, n_control: int, emit=print):
    """Set the cell up once, then ``emit`` one reading a seed and one a
    control seed: ``{"seed", "side", "values", "check_s"}``."""
    import numpy as np
    import torch

    from gpu_bench.check import CONTROL
    from gpu_bench.run import analysis_seed

    entry = cell.entry()
    state = entry.setup(bench)
    control = getattr(torch, CONTROL[cell.config["dtype"]])
    for k, seed in enumerate(seeds):
        s_0 = analysis_seed(seed, 0)
        _, result = entry.run(state, s_0)
        sides = [("program", None)] + ([("control", control)] if k < n_control else [])
        for side, compute in sides:
            t = time.perf_counter()
            values = entry.check(bench, result, s_0, np.random.default_rng([abs(int(seed)), 0]),
                                 compute=compute)
            emit({"cell": cell.name, "seed": seed, "side": side, "check_s":
                  time.perf_counter() - t, "values": {k: float(v) for k, v in values.items()}})
        del result


def main(argv=None, *, root=None, device=None) -> int:
    from gpu_bench.run import prepare

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--control", type=int, default=3,
                    help="how many of the seeds the control reads")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell, bench = prepare(args.workload, root, device)
    if bench is None:
        return 3

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    readings(cell, bench, [int(s) for s in args.seeds.split(",")], args.control, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
