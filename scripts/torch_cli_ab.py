#!/usr/bin/env python3
"""The port's redocking CLI as a user runs it, a fresh process per run, in
two checkouts, on one CUDA card: the wall of the whole command (Python
start, CUDA start, model load, featurization, docking, outputs) for

  * `one`:  5SAK_ZRY_A_1 at crop 256/2048 (chip_smoke.py's main dock);
  * `four`: the 4 demo systems at crop 128/1024 (its accuracy dock),

each with 40 steps, 2 rounds of 20 poses, 64 conformers, fp32.  Each
checkout first runs `one` untimed (it builds the kernels into its
`build/`); then the checkouts alternate A, B, B, A, ROUNDS times.  Prints
one JSON line per run and the medians per checkout and case.

    python3 scripts/torch_cli_ab.py DIR_A DIR_B [ROUNDS]

To compare a change with its parent, unpack the parent into a directory
that .gitignore lists (`git archive`) and pass both directories, in one
call on the card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

CASES = {
    "one": (["-i", "demo/redocking/Posebusters_subset/5SAK_ZRY_A_1.pkl.gz"], 256, 2048),
    "four": (["-f", "demo/redocking/Posebusters_subset"], 128, 1024),
}


def run(checkout: str, case: str, out: str) -> dict:
    inputs, crop, atom_crop = CASES[case]
    feats = "demo/redocking/features"
    cmd = [
        sys.executable, "-m", "physdock_tpu_torch.cli.redocking", *inputs, "-o", out,
        "--params", "_overfit/ema_params.npz", "--model_name", "toy",
        "--crop_size", str(crop), "--atom_crop_size", str(atom_crop),
        "--msa_features_dir", f"{feats}/msa_features",
        "--uniprot_msa_features_dir", f"{feats}/uniprot_msa_features",
        "--steps", "40", "--max_rounds", "2", "--num_samples_per_round", "20",
        "--max_samples", "40", "--num_confs", "64", "--pocket_cutoff", "6.0",
        "--use_pocket", "--use_key_res", "--enable_physics_correction", "--enable_ranking",
        "--device", "cuda",
    ]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    if proc.returncode != 0:
        sys.exit(f"torch_cli_ab: {checkout} {case} exited {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    return {"checkout": checkout, "case": case, "wall_s": wall,
            "systems": len(summary),
            "top1": [r["top5_rmsd"][0] for r in summary],
            "load_s": [r["timings"]["load_s"] for r in summary],
            "rounds_s": [r["timings"]["rounds_s"] for r in summary]}


def main():
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    a, b = (os.path.abspath(d) for d in sys.argv[1:3])
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    os.makedirs(os.path.join(a, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cli_ab_", dir=os.path.join(a, "build"))
    n = 0

    def once(checkout, case):
        nonlocal n
        n += 1
        return run(checkout, case, os.path.join(work, f"{n:03d}_{case}"))

    for checkout in (a, b):  # builds the kernels in each checkout
        once(checkout, "one")
    walls = {}
    for _ in range(rounds):
        for checkout in (a, b, b, a):
            for case in CASES:
                r = once(checkout, case)
                print(json.dumps(r), flush=True)
                walls.setdefault((checkout, case), []).append(r["wall_s"])
    for (checkout, case), w in sorted(walls.items()):
        print(json.dumps({"checkout": checkout, "case": case, "median_wall_s": statistics.median(w),
                          "walls": w}), flush=True)


if __name__ == "__main__":
    main()
