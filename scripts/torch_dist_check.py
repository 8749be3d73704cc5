"""Train the port over several processes at a few dp x tp layouts and
compare them (`physdock_tpu_torch.train.train`, one process a card).

    python scripts/torch_dist_check.py --layouts 2x1,2x2      # 4 cards: NCCL
    python scripts/torch_dist_check.py --layouts 2x1,2x2 --device cpu \\
        --model toy --crop 32 --atom_crop 256 --aug 2         # the CPU: gloo

Each layout DPxTP runs DP*TP processes of the train CLI on one host
(`--coordinator localhost:<free port>`, `--tp TP`, a global batch of DP
systems: one a replica) on the demo systems, from one seed, into its own
output directory; rank 0 writes `scalars.jsonl`. Layouts of one dp see
the same systems (each replica's sampler stream depends on its dp rank
only), so their losses must agree: the script prints each layout's
losses, seconds per step (from the metrics lines' clock, steps 2..) and
every rank's peak memory on the card, and the largest relative loss
difference of every layout from the first of its dp, as one JSON line,
then the card line.
It exits non-zero if a process fails or a difference exceeds --rel.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = os.path.join(REPO, "demo", "redocking", "Posebusters_subset")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_layout(dp: int, tp: int, args, work: str) -> dict:
    n = dp * tp
    out = os.path.join(work, f"dp{dp}_tp{tp}")
    port = free_port()
    cmd = [sys.executable, "-m", "physdock_tpu_torch.train.train", "--dataset_dir",
           os.path.join(work, "data"), "-o", out, "--model_name", args.model, "--crop_size",
           str(args.crop), "--atom_crop_size", str(args.atom_crop), "--num_augmentation_sample",
           str(args.aug), "--batch_size", str(dp), "--total_steps", str(args.steps),
           "--save_every", str(args.steps), "--seed", "0", "--device", args.device, "--tp",
           str(tp), "--coordinator", f"localhost:{port}", "--num_processes", str(n)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(args.threads))
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=work, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        for i, text in enumerate(logs):
            print(f"--- process {i} (rc {procs[i].returncode}):\n{text[-4000:]}", flush=True)
        raise SystemExit(f"layout {dp}x{tp}: a process failed")
    lines = [json.loads(x) for x in open(os.path.join(out, "scalars.jsonl"))]
    times = [x["time"] for x in lines]
    peaks = [int(line.split()[-2]) for text in logs for line in text.splitlines()
             if "peak memory allocated" in line]
    return {"dp": dp, "tp": tp, "losses": [x["loss"] for x in lines],
            "s_per_step": [b - a for a, b in zip(times, times[1:])],
            "peak_memory_bytes": peaks}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--layouts", default="2x1,2x2", help="comma-separated DPxTP")
    p.add_argument("--model", default="medium")
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--atom_crop", type=int, default=2048)
    p.add_argument("--aug", type=int, default=48)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--rel", type=float, default=1e-3,
                   help="largest relative loss difference within one dp")
    p.add_argument("--timeout", type=float, default=1500.0)
    p.add_argument("--work", default=None)
    args = p.parse_args(argv)
    work = args.work or tempfile.mkdtemp(prefix="dist_check_")
    os.makedirs(os.path.join(work, "data", "train_val"), exist_ok=True)
    for f in sorted(os.listdir(SYSTEMS)):
        link = os.path.join(work, "data", "train_val", f)
        if not os.path.exists(link):
            os.symlink(os.path.join(SYSTEMS, f), link)
    if args.device != "cpu":  # built once here: the ranks find the libraries fresh
        sys.path.insert(0, REPO)
        from physdock_tpu_torch.ops import _flash_lib

        _flash_lib.build_all()
    results, first, worst = [], {}, 0.0
    for layout in args.layouts.split(","):
        dp, tp = (int(x) for x in layout.split("x"))
        r = run_layout(dp, tp, args, work)
        ref = first.setdefault(dp, r)
        r["rel_to_first_of_dp"] = max(abs(a - b) / abs(b) for a, b in
                                      zip(r["losses"], ref["losses"]))
        worst = max(worst, r["rel_to_first_of_dp"])
        print(json.dumps(r), flush=True)
        results.append(r)
    print(json.dumps({"layouts": results, "worst_rel": worst}), flush=True)
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip(), flush=True)
    if worst > args.rel:
        raise SystemExit(f"losses differ within one dp by {worst} > {args.rel}")


if __name__ == "__main__":
    main()
