"""Readings for the limits of a cell's comparison: the program's numbers
and the control's (the plain reference at a lower precision standing in
the program's place), over many seeds in one process.

    python3 perfbench/calibrate.py --workload CELL --seeds 1,2,3 \
        [--controls tf32] [--out FILE]

Prints one JSON line per seed; the benchmark's own runs never run it."""

import argparse
import json
import os
import shutil
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.lib import harness

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="tf32")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    cell = harness.find_cell(args.workload)
    harness.set_environment()
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    ctx = harness.Context(cell, 0, 0, False, device, 0.0)
    driver = harness.load_module(os.path.join(cell.root, "perfbench", "drivers",
                                              cell.traffic["driver"] + ".py"), "driver")
    try:
        rows = driver.readings(ctx, [int(s) for s in args.seeds.split(",")],
                               tuple(c for c in args.controls.split(",") if c))
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": device, "rows": rows}, f, indent=1)
