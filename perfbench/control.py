#!/usr/bin/env python3
"""Read the numbers that set a cell's check limit, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 [--seconds 15]

In one process, for each seed, a short run of the cell (set-up, window,
check as ``run.py`` makes them) prints the numbers the check compares
for the program's served tokens (the lower readings); on each control
seed it also prints the summaries (``check.stats``) of the program's
gaps and of the gaps of the tokens that the reference in fp8 puts first
(the control's readings). One JSON line a seed; the benchmark's runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"          # as run.py runs the cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: not measuring", file=sys.stderr)
        return 2
    from perfbench import harness
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = harness.run(args.workload, s, args.seconds, False, "cuda",
                          control=s in ctrl)
        c = rec["check"]
        print(json.dumps({"workload": args.workload, "seed": s,
                          "numbers": c["numbers"], "correct": c["correct"],
                          "requests": c["requests"], "tokens": c["tokens"],
                          "stats": c.get("stats"),
                          "setup_s": rec["setup_s"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
