"""One training step on one device (port of `physdock_tpu/train/step.py`).

For each system of the batch: forward, loss and backward; that system's
gradient is clipped to 0.1 by its global norm (the reference's
per-sample clip, train.sh --per-sample-clip-norm) and added to an fp32
accumulator.  The sum is divided by the batch size, then the optimizer
(global clip 10, Adam, schedule) and the EMA run.  The `dp` mesh of the
JAX step waits for the multi-GPU slice, and `use_mini_rollout` for the
confidence module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from physdock_tpu_torch.config import LossConfig
from physdock_tpu_torch.model.losses import physdock_loss
from physdock_tpu_torch.train.optim import AdamState, Optimizer, clip_by_norm, ema_update

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree  # the model's own Parameters, updated in place
    opt_state: AdamState
    ema_params: Tree


def init_train_state(model: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        ema_params={n: p.detach().float().clone() for n, p in params.items()},
    )


def make_train_step(model, optimizer: Optimizer, loss_cfg: LossConfig,
                    per_replica_clip: float = 0.1, ema_decay: float = 0.999,
                    sigma_data: float = 16.0):
    """Build `train_step(state, batch, generator) -> (state, logs)`.

    batch: dict of tensors on the model's device with a leading system
    axis; `generator` (a CPU `torch.Generator`) draws every system's
    noise. logs are the batch means of the loss terms, as floats."""

    def train_step(state: TrainState, batch: Tree, generator: Optional[torch.Generator] = None):
        names = list(state.params)
        leaves = [state.params[n] for n in names]
        n_sys = next(iter(batch.values())).shape[0]
        grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in state.params.items()}
        logs_sum: Dict[str, torch.Tensor] = {}
        for i in range(n_sys):
            micro = {k: v[i] for k, v in batch.items()}
            loss, logs = physdock_loss(model(micro, generator), micro, loss_cfg,
                                       sigma_data=sigma_data)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = {n: torch.zeros_like(p) if gi is None else gi
                 for n, p, gi in zip(names, leaves, g)}
            for n, gi in clip_by_norm(g, per_replica_clip).items():
                grads[n].add_(gi.float())
            for k, v in logs.items():
                logs_sum[k] = logs_sum.get(k, 0.0) + v.detach().float()
        grads = {n: g / n_sys for n, g in grads.items()}
        updates, opt_state = optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            for n, u in updates.items():
                state.params[n].add_(u.to(state.params[n].dtype))
        ema_update(state.ema_params, state.params, ema_decay)
        state = dataclasses.replace(state, step=state.step + 1, opt_state=opt_state)
        return state, {k: float(v) / n_sys for k, v in logs_sum.items()}

    return train_step
