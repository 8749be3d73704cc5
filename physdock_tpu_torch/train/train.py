"""Training CLI (port of `physdock_tpu/train/train.py`), on one card or
on several, one process per card.

    python -m physdock_tpu_torch.train.train --dataset_dir DATA -o ckpts/ \
        --model_name medium --crop_size 256 --atom_crop_size 2048

    # 4 cards: 2 replicas (dp) of 2 pair-row shards (tp); one process each
    for i in 0 1 2 3; do python -m physdock_tpu_torch.train.train ... \
        --batch_size 2 --tp 2 --coordinator localhost:29500 \
        --num_processes 4 --process_id $i & done

`DATA/train_val/` holds the prepared system `.pkl.gz` files (optional
`DATA/train_val_weights.json`). Runs on the card unless `--device cpu`.
Each step featurizes `--batch_size` systems in training mode (on a
background thread), runs the train step, and saves the train state every
`--save_every` steps, keeping `--keep_ckpts`. `main` returns a summary:
losses, seconds per step (the wait for the batch and its copy to the
device included, the checkpoint save not), that wait alone, checkpoints
and sampler retries.  Resumes from
the newest checkpoint in the output dir, or starts from `--init_from_ckpt`
(a train-state `.pt` or a JAX `.npz` parameter artifact). The step's
noise is keyed by `--seed`, the step and the system (`train/draws.py`),
so a resumed run draws from the step it resumes at (the JAX trainer
restarts its key chain from `PRNGKey(seed)`).
Each process drives `cuda:{process_id % cards}` (the JAX package runs one
process per host over all its chips); `--coordinator` starts the process
group (NCCL, gloo with `--device cpu`). The `--batch_size` systems of a
step split over dp = num_processes / tp replicas, each featurizing its
own from a sampler stream of its own; the ranks of a replica share them
(`train/step.py`). Rank 0 alone writes the checkpoints (which hold the
EMA) and the `scalars.jsonl` metrics lines (`train/metrics.py`).
`--use_mini_rollout` builds the confidence head and trains it on a short
no-grad rollout of `--mini_rollout_steps` steps (the head's parameters
then sit in the optimizer, the EMA, the checkpoints and the exported
`.npz`); `--alpha_pae` sets the PAE loss weight (alpha_confidence *
alpha_pae).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from physdock_tpu_torch.cli.common import load_model
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.infer.pipeline import arrays_to_device, resolve_device
from physdock_tpu_torch.model.import_weights import is_train_state, read_checkpoint
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.parallel import mesh as mesh_lib
from physdock_tpu_torch.train import checkpoint as ckpt_lib
from physdock_tpu_torch.train.metrics import MetricsLogger
from physdock_tpu_torch.train.optim import make_optimizer
from physdock_tpu_torch.train.sampler import WeightedSystemSampler, batch_iterator, prefetch
from physdock_tpu_torch.train.step import init_train_state, make_train_step
from physdock_tpu_torch.utils.profiling import device_trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("-o", "--ckpt_dir", required=True)
    p.add_argument("--model_name", default="medium",
                   choices=["toy", "tiny", "small", "medium", "full"])
    p.add_argument("--batch_size", type=int, default=1,
                   help="systems per step over all replicas: a multiple of dp")
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--atom_crop_size", type=int, default=2048)
    p.add_argument("--num_augmentation_sample", type=int, default=48)
    p.add_argument("--total_steps", type=int, default=120000)
    p.add_argument("--lr", type=float, default=1.8e-3)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=400)
    p.add_argument("--keep_ckpts", type=int, default=40)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--use_mini_rollout", action="store_true",
                   help="train the PAE/PDE/pLDDT confidence heads on a short no-grad rollout "
                        "(train.sh --use-mini-rollout)")
    p.add_argument("--mini_rollout_steps", type=int, default=12)
    p.add_argument("--alpha_pae", type=float, default=None,
                   help="override LossConfig.alpha_pae (pae weight = alpha_confidence * "
                        "alpha_pae)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute; parameters, gradients, Adam moments and EMA stay fp32")
    p.add_argument("--init_from_ckpt", default=None,
                   help="a train-state .pt of this trainer (resumed), or weights to start "
                        "from: a JAX .npz artifact or a reference params.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked: --device cpu)")
    p.add_argument("--tp", type=int, default=1,
                   help="pair-row tensor-parallel ranks per replica (parallel/tp.py); "
                        "dp = num_processes / tp")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0's rendezvous (or an init URL such as "
                        "file:///path): starts the process group, one process per card on "
                        "cuda:{process_id %% cards}, where the JAX package runs one process "
                        "per host")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler trace of the training loop to DIR/trace.json "
                        "(Perfetto; rank 0): host and card activity with the program's "
                        "physdock.* spans")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.coordinator:
        mesh_lib.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                  backend="nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and mesh_lib.distributed():
        device = torch.device("cuda", mesh_lib.rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
        _flash_lib.build_on_rank0()
    mesh = mesh_lib.make_mesh(tp=args.tp)
    if args.batch_size % mesh.dp:
        raise ValueError(f"--batch_size {args.batch_size} is not a multiple of dp={mesh.dp}")
    writer = mesh_lib.rank() == 0
    cfg = PhysDockConfig.named(
        args.model_name,
        crop_size=args.crop_size,
        atom_crop_size=args.atom_crop_size,
        bf16=args.bf16,
        inference_mode=False,
        num_augmentation_sample=args.num_augmentation_sample,
    )

    resume = args.init_from_ckpt or ckpt_lib.latest_checkpoint(args.ckpt_dir)
    ckpt = read_checkpoint(resume) if resume and not resume.endswith(".npz") else None
    full = is_train_state(ckpt)
    loss_cfg = cfg.loss
    if args.alpha_pae is not None:
        loss_cfg = dataclasses.replace(loss_cfg, alpha_pae=args.alpha_pae)
    model = load_model(None if full else resume, cfg, seed=args.seed,
                       with_confidence=args.use_mini_rollout, ckpt=ckpt).to(device).train()
    optimizer = make_optimizer(args.lr, args.warmup_steps)
    state = init_train_state(model, optimizer)
    if full:
        state = ckpt_lib.restore_train_state(ckpt, state, resume)
        print(f"resumed from {resume} at step {state.step}", flush=True)
    elif resume:
        print(f"weights from {resume}; fresh optimizer state at step 0", flush=True)
    train_step = make_train_step(model, optimizer, loss_cfg, ema_decay=args.ema_decay,
                                 sigma_data=cfg.model.sigma_data,
                                 use_mini_rollout=args.use_mini_rollout,
                                 mini_rollout_steps=args.mini_rollout_steps, mesh=mesh)

    featurizer = SystemFeaturizer(cfg.data, inference_mode=False, seed=args.seed,
                                  pad_to_bucket=False)
    # a stream of systems per replica; the ranks of a replica share it
    sampler = WeightedSystemSampler.from_dataset_dir(args.dataset_dir,
                                                     args.seed + 7919 * mesh.dp_rank)
    batches = prefetch(batch_iterator(sampler, featurizer, args.batch_size // mesh.dp,
                                      args.crop_size, args.atom_crop_size))
    metrics = MetricsLogger(args.ckpt_dir) if writer else None
    summary = {"device": str(device), "start_step": state.step, "steps": [], "logs": [],
               "step_seconds": [], "wait_seconds": [], "checkpoints": []}
    try:
        with device_trace(args.trace_dir if writer else None):
            while state.step < args.total_steps:
                t0 = time.time()
                batch = arrays_to_device(next(batches), device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t_wait = time.time() - t0
                state, logs = train_step(state, batch, args.seed)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.time() - t0
                summary["steps"].append(state.step)
                summary["logs"].append(logs)
                summary["step_seconds"].append(dt)
                summary["wait_seconds"].append(t_wait)
                if not writer:
                    continue
                metrics.log(state.step, logs)
                if state.step % 10 == 0 or state.step == args.total_steps:
                    print(f"step {state.step} loss {logs['loss']:.4f} ({dt:.2f}s) {logs}",
                          flush=True)
                if state.step % args.save_every == 0:
                    path = ckpt_lib.save_train_state(args.ckpt_dir, state, args.keep_ckpts)
                    summary["checkpoints"].append(path)
                    print(f"checkpoint: {path}", flush=True)
    finally:
        batches.close()
        if metrics is not None:
            metrics.close()
        if args.coordinator:
            mesh_lib.close_distributed()
    if device.type == "cuda":
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        print(f"rank {mesh_lib.rank()}: peak memory allocated {summary['peak_memory_bytes']} B",
              flush=True)
    summary["retries"] = sampler.retries
    summary["state"] = state
    summary["model"] = model
    return summary


if __name__ == "__main__":
    main()
