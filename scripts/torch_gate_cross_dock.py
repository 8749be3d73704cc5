"""Dock the 4 demo systems with one set of EMA weights through both
packages' redocking CLIs on the CPU, at the train-to-dock gate's dock
settings: it tells a trained model that docks wrongly from a dock that
goes wrong.

    python scripts/torch_gate_cross_dock.py EMA.npz OUT [--seed 1] [--threads 4]

The weights are a `.npz` in the JAX package's flat layout (what
`scripts/torch_overfit_gate.py` and `scripts/overfit_gate.py` write).
Both CLIs run at once, each in its own process on the CPU: crop
128/1024, 40 steps, 2 rounds of 20 poses, 64 conformers, pocket cutoff
6 A, physics correction and ranking, featurizer and sampler seeded with
`--seed` (the gate docks with its training seed). Prints one JSON line:
per package and system the top-ranked RMSD and the top-5, and the gate's
verdict (top-1 and every top-5 pose below 2 A on 4/4).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "redocking")
# the JAX package on the CPU: its platform is chosen through jax.config
JAX_MAIN = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
            "from physdock_tpu.cli.redocking import main; main(sys.argv[1:])")
PORT_MAIN = "import sys; from physdock_tpu_torch.cli.redocking import main; main(sys.argv[1:])"


def flags(out: str, params: str, seed: int):
    feats = os.path.join(DEMO, "features")
    return ["-f", os.path.join(DEMO, "Posebusters_subset"), "-o", out, "--params", params,
            "--model_name", "toy", "--crop_size", "128", "--atom_crop_size", "1024",
            "--msa_features_dir", os.path.join(feats, "msa_features"),
            "--uniprot_msa_features_dir", os.path.join(feats, "uniprot_msa_features"),
            "--steps", "40", "--max_rounds", "2", "--num_samples_per_round", "20",
            "--max_samples", "40", "--num_confs", "64", "--pocket_cutoff", "6.0",
            "--use_pocket", "--use_key_res", "--enable_physics_correction", "--enable_ranking",
            "--seed", str(seed)]


def verdict(summary):
    res = {r["system_id"]: {"top_rmsd": r["top5_rmsd"][0], "top5_rmsd": r["top5_rmsd"][:5]}
           for r in summary}
    ok = len(res) == 4 and all(max(v["top5_rmsd"]) < 2.0 for v in res.values())
    return {"pass": ok, "results": res}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("params")
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(args.threads),
               JAX_PLATFORMS="cpu")
    os.makedirs(args.out, exist_ok=True)
    runs = {}
    for name, code, extra in (("jax", JAX_MAIN, []), ("port", PORT_MAIN, ["--device", "cpu"])):
        out = os.path.join(args.out, name)
        log = open(os.path.join(args.out, f"{name}.log"), "w")
        runs[name] = (out, subprocess.Popen(
            [sys.executable, "-c", code, *flags(out, os.path.abspath(args.params), args.seed),
             *extra], env=env, cwd=args.out, stdout=log, stderr=subprocess.STDOUT))
    report = {"params": args.params, "seed": args.seed}
    for name, (out, proc) in runs.items():
        if proc.wait() != 0:
            raise SystemExit(f"the {name} CLI failed (rc {proc.returncode}): see "
                             f"{os.path.join(args.out, name + '.log')}")
        with open(os.path.join(out, "summary.json")) as f:
            report[name] = verdict(json.load(f))
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
