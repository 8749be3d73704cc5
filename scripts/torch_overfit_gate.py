"""Train-to-dock gate of the PyTorch port (`physdock_tpu_torch`), the
counterpart of `scripts/overfit_gate.py`.

Train the toy preset from random weights (`--seed`) on the 4 demo
PoseBusters systems until it overfits them, then redock them through the
whole guided pipeline (featurizer, trunk, EDM sampler, physics guidance,
chirality, ranking, writers) with the EMA weights. Pass: the top-ranked
ligand RMSD and the largest of the top-5 below 2 A on every system, the
JAX gate's rule, after all `--steps` (a window that stopped short writes
its dock's verdicts, `pass_top_ranked` and `pass_all_top5`, and
`"pass": false`).

The recipe is the JAX gate's: crop 128/1024, 8 augmentation samples, lr
1e-3 with 100 warmup steps, the systems featurized once in inference mode
(so training sees the features the dock sees) and grouped by shape
signature, one stacked batch per group, the steps rotating over the
groups, each system taking one of its 4 MSA variants at random each step;
bf16 compute on the card (fp32 parameters, Adam moments and EMA), fp32 on
the CPU. The dock: 40 steps, 2 rounds of 20 poses, physics correction and
ranking, 64 conformers on the card (8 on the CPU). The blocks keep their
activations under grad instead of recomputing them (`set_remat`), which
changes no number.

Runs in resumable windows: the train state is saved every `--ckpt_every`
steps (and when the window ends) under `OUT/ckpts`, and a later run
resumes from the newest one; `--deadline_ts` (unix time) ends a window's
training and goes on to the dock, so each window writes the gate file.
The port's draws are keyed by (`--seed`, step): the train step's noise
per system (`physdock_tpu_torch/train/draws.py`) and each step's MSA
variants, so a run in windows draws exactly what one call draws.

`--draws jax` replaces the port's draws by the JAX gate's own
(`scripts/torch_jax_draws.py`: the same keys, t_hat, noise and centre
augmentation as `scripts/overfit_gate.py` at the same `--seed`, fed
through the train step's `draws` argument, and its MSA variant stream),
the resume step folded into both as the JAX gate folds it: a diagnostic
that makes the last input of training equal to the JAX gate's.

On the card the train step replays each system's forward and backward
as CUDA graphs (`make_train_step(cuda_graph=True)`): the eager step's
kernels in the same order (bit for bit under deterministic algorithms,
`chip_smoke.py` phase 9d) without the host's cost of their launches, so
that several gates can share one card. On the CPU the step is eager.

    python scripts/torch_overfit_gate.py --deadline_ts $(( $(date +%s) + 3000 ))
    python scripts/torch_overfit_gate.py --device cpu --steps 4 --crop 64 \\
        --atom_crop 512 --aug 2 --dock_rounds 1 --dock_poses 2   # CPU smoke

Writes `--gate_out` (default TORCH_OVERFIT_GATE.json at the repo root):
OVERFIT_GATE.json's keys, plus the device with its name and power limit,
seconds per step and peak memory of each window, and the SHA-256 of the
EMA weights written to OUT/ema_params.npz (the JAX package's flat
layout). OUT/scalars.jsonl logs the loss terms every step.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--atom_crop", type=int, default=1024)
    p.add_argument("--aug", type=int, default=8)
    p.add_argument("--model", default="toy")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--out", default=os.path.join(REPO, "_overfit_torch"))
    p.add_argument("--gate_out", default=os.path.join(REPO, "TORCH_OVERFIT_GATE.json"))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked: --device cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dock_steps", type=int, default=40)
    p.add_argument("--dock_rounds", type=int, default=2)
    p.add_argument("--dock_poses", type=int, default=20)
    p.add_argument("--fp32", action="store_true",
                   help="fp32 compute on the card too (a diagnostic: the recipe trains in bf16 "
                        "on the card, as the JAX gate did on its accelerator)")
    p.add_argument("--draws", choices=("port", "jax"), default="port",
                   help="the train step's noise: the port's generator, or the JAX gate's "
                        "keys reproduced by scripts/torch_jax_draws.py")
    p.add_argument("--deadline_ts", type=float, default=0.0,
                   help="unix time at which this window stops training, saves the train "
                        "state and docks (0: no deadline)")
    return p.parse_args(argv)


def card_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    import torch

    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "nvidia_smi": line,
            "power_limit": line.split(",")[-1].strip()}


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.infer.pipeline import (
        DockingPipeline,
        SamplerSettings,
        arrays_to_device,
        resolve_device,
    )
    from physdock_tpu_torch.model.physdock import prepare_batch
    from physdock_tpu_torch.nn.transformers import set_remat
    from physdock_tpu_torch.train import checkpoint as ckpt_lib
    from physdock_tpu_torch.train.metrics import MetricsLogger
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state, make_train_step
    from physdock_tpu_torch.utils.demo_assets import (
        redocking_features_dir,
        redocking_systems_dir,
    )

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    card = card_info(device)
    print(f"device: {json.dumps(card)}", flush=True)
    cfg = PhysDockConfig.named(
        args.model, crop_size=args.crop, atom_crop_size=args.atom_crop,
        bf16=on_card and not args.fp32,
        infer_use_pocket=True, infer_use_key_res=True, num_augmentation_sample=args.aug)
    os.makedirs(args.out, exist_ok=True)
    feats_dir = redocking_features_dir()
    featurizer = SystemFeaturizer(
        cfg.data, msa_features_dir=f"{feats_dir}/msa_features",
        uniprot_msa_features_dir=f"{feats_dir}/uniprot_msa_features", inference_mode=True,
        seed=args.seed)
    systems = sorted(glob.glob(f"{redocking_systems_dir()}/*.pkl.gz"))
    if not systems:
        raise FileNotFoundError("demo systems unavailable")

    # every system featurized once; its 4 MSA variants give the steps
    # diversity (the dock-time featurizer resamples the MSA the same way)
    t0 = time.time()
    feats_list, msa_variants = [], []
    for s in systems:
        f, meta = featurizer.load(s, num_msa_rounds=4)
        variants = meta.get("batch_msa_feat")
        msa_variants.append([] if variants is None else [np.asarray(v) for v in variants])
        feats_list.append(dict(f))
    print(f"featurized {len(systems)} systems in {time.time() - t0:.1f} s", flush=True)

    # systems land in different atom buckets: one stacked batch per shape
    # signature, the steps rotating over the groups
    keys0 = set(feats_list[0])
    if any(set(f) != keys0 for f in feats_list[1:]):
        raise ValueError("the systems' feature keys differ")
    groups: dict = {}
    for idx, f in enumerate(feats_list):
        groups.setdefault(tuple(sorted((k, np.shape(v)) for k, v in f.items())), []).append(idx)
    group_idx = list(groups.values())
    print(f"bucket groups: {[len(g) for g in group_idx]}", flush=True)

    model = load_model(None, cfg, seed=args.seed).to(device).train()
    # the toy model at this crop keeps every activation in a few GB: no
    # recompute under grad, a quarter fewer launches per step, same numbers
    set_remat(model, False)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M, compute "
          f"{cfg.dtypes.compute_dtype}", flush=True)
    optimizer = make_optimizer(args.lr, args.warmup)
    state = init_train_state(model, optimizer)
    ckpt_dir = os.path.join(args.out, "ckpts")
    resume = ckpt_lib.latest_checkpoint(ckpt_dir)
    if resume:
        state = ckpt_lib.restore_train_state(resume, state)
        print(f"resumed at step {state.step} from {resume}", flush=True)
    start_step = state.step
    # graphed on the card (a CPU batch takes the eager step)
    train_step = make_train_step(model, optimizer, cfg.loss, sigma_data=cfg.model.sigma_data,
                                 cuda_graph=True)

    if args.draws == "jax":
        # the JAX gate's streams: the window's start step folded in
        msa_rng = np.random.default_rng((args.seed, start_step))
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import torch_jax_draws

        jax_keys = torch_jax_draws.GateKeys(args.seed, start_step)

    def step_draws(batch):
        """The JAX gate's draws for this step's systems (None: the port's)."""
        if args.draws != "jax":
            return None
        k_step = jax_keys.next_step()
        n = next(iter(batch.values())).shape[0]
        micros = [prepare_batch({k: v[i] for k, v in batch.items()}) for i in range(n)]
        return [torch_jax_draws.system_draws(jax_keys.system_key(k_step, i), m["x_gt"],
                                             m["x_exists"], args.aug, cfg.model.sigma_data)
                for i, m in enumerate(micros)]

    def build_batch(step_i):
        members = group_idx[step_i % len(group_idx)]
        batch = {k: np.stack([np.asarray(feats_list[i][k]) for i in members]) for k in keys0}
        rng = msa_rng if args.draws == "jax" else np.random.default_rng((args.seed, step_i))
        if all(msa_variants[i] for i in members):
            batch["msa_feat"] = np.stack(
                [msa_variants[i][rng.integers(len(msa_variants[i]))] for i in members])
        return arrays_to_device(batch, device)

    metrics = MetricsLogger(args.out)
    losses, terms_hist, step_s = [], [], []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_train = time.time()
    try:
        for step_i in range(start_step, args.steps):
            # the first step of a window builds the kernels: start it only
            # with time to spare before the deadline
            margin = 120.0 if step_i == start_step else 0.0
            if args.deadline_ts and time.time() > args.deadline_ts - margin:
                print(f"deadline reached at step {step_i}; stopping training", flush=True)
                break
            t0 = time.time()
            batch = build_batch(step_i)
            state, logs = train_step(state, batch, args.seed, draws=step_draws(batch))
            losses.append(logs["loss"])  # a float: the step has ended on the card
            step_s.append(time.time() - t0)
            terms_hist.append(logs)
            metrics.log(state.step, logs)
            if state.step % 25 == 0:
                recent = {k: float(np.mean([h[k] for h in terms_hist[-25:]]))
                          for k in terms_hist[-1]}
                tstr = " ".join(f"{k.replace('_loss', '')}={v:.3f}" for k, v in recent.items())
                print(f"step {state.step} loss {recent['loss']:.4f} "
                      f"({np.mean(step_s[-25:]):.3f} s/step) [{tstr}]", flush=True)
            if state.step % args.ckpt_every == 0:
                print(f"ckpt: {ckpt_lib.save_train_state(ckpt_dir, state, keep=3)}", flush=True)
    finally:
        metrics.close()
    train_s = time.time() - t_train
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite training loss: {losses[-25:]}")
    if state.step > start_step and state.step % args.ckpt_every:
        print(f"final ckpt: {ckpt_lib.save_train_state(ckpt_dir, state, keep=3)}", flush=True)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    npz_path = os.path.join(args.out, "ema_params.npz")
    ckpt_lib.save_params_npz(npz_path, state.ema_params)
    window = {"start_step": start_step, "end_step": state.step, "train_s": train_s,
              # the window's first step builds the kernels: steps 2.. only
              "s_per_step": float(np.mean(step_s[1:])) if len(step_s) > 1 else None,
              "first_step_s": step_s[0] if step_s else None, "peak_memory_bytes": peak,
              "nproc": os.cpu_count(), "omp_num_threads": os.environ.get("OMP_NUM_THREADS"),
              "device": card}
    with open(os.path.join(args.out, "windows.jsonl"), "a") as f:
        f.write(json.dumps(window) + "\n")
    with open(os.path.join(args.out, "windows.jsonl")) as f:
        windows = [json.loads(line) for line in f]
    print(f"window: {json.dumps(window)}", flush=True)

    print("docking with the EMA weights...", flush=True)
    dock_model = load_model(None, cfg, seed=args.seed)
    dock_model.load_state_dict(state.ema_params, strict=True)
    settings = SamplerSettings(
        max_samples=2 * args.dock_poses, num_samples_per_round=args.dock_poses,
        max_rounds=args.dock_rounds, steps=args.dock_steps, enable_physics_correction=True,
        num_confs=64 if on_card else 8, enable_ranking=True, seed=args.seed)
    pipe = DockingPipeline(cfg, dock_model, featurizer, settings, device=device)
    results = {}
    for s in systems:
        name = os.path.basename(s).replace(".pkl.gz", "")
        r = pipe.dock(s, os.path.join(args.out, "dock", name), write_outputs=True)
        results[name] = {"top_rmsd": float(r["top5_rmsd"][0]),
                         "top5_rmsd": [float(x) for x in r["top5_rmsd"][:5]],
                         "rounds": r["rounds"]}
        print(f"  {name}: {results[name]}", flush=True)

    ok_top = all(v["top_rmsd"] < 2.0 for v in results.values())
    ok_top5 = all(max(v["top5_rmsd"]) < 2.0 for v in results.values())
    out = {
        # a window that stopped short of --steps is not a gate run at the recipe
        "pass": ok_top and ok_top5 and state.step == args.steps,
        "pass_top_ranked": ok_top,
        "pass_all_top5": ok_top5,
        "steps": state.step,
        "steps_requested": args.steps,
        "model": args.model,
        "crop": args.crop,
        "atom_crop": args.atom_crop,
        "final_loss": float(np.mean(losses[-25:])) if losses else None,
        "results": results,
        "device": card,
        "compute_dtype": str(cfg.dtypes.compute_dtype).replace("torch.", ""),
        "recipe": {"seed": args.seed, "draws": args.draws, "lr": args.lr, "warmup": args.warmup, "aug": args.aug,
                   "dock_steps": args.dock_steps, "dock_rounds": args.dock_rounds,
                   "dock_poses": args.dock_poses, "num_confs": settings.num_confs},
        "seconds_per_step": window["s_per_step"],
        "peak_memory_bytes": peak,
        "windows": windows,
        "ema_npz_sha256": sha256(npz_path),
    }
    with open(args.gate_out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
