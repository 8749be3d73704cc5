"""Optimizer and schedule of the reference training recipe (port of
`physdock_tpu/train/optim.py`), as plain tensor functions.

(reference: tasks/unicore_train/train.sh:69-110)
  adam betas (0.9, 0.95) eps 1e-8; lr 1.8e-3, linear warmup 1000 steps then
  stair exponential decay x0.998 every 1000 steps; per-system grad clip 0.1
  before the batch mean + global clip 10 after; fp32 grad reduction; EMA of
  params with decay 0.999.

`make_optimizer` is optax's chain `clip_by_global_norm(10)`,
`scale_by_adam`, `scale_by_learning_rate(schedule)` in that order, over
dicts of tensors.  The Adam moments and the EMA are updated in place (one
copy of each instead of two).  Every per-tensor loop is a `torch._foreach_*`
call: the same elementwise arithmetic over all tensors in a few launches
(a model has hundreds of parameter tensors, most of them small, so one
launch per tensor and operation would cost more than the arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


def stair_exp_warmup_schedule(peak_lr: float = 1.8e-3, warmup_steps: int = 1000,
                              decay_rate: float = 0.998, decay_every: int = 1000
                              ) -> Callable[[int], float]:
    """Learning rate at an update count, in float32 as the JAX schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        # (step+1)/warmup so the very first update is non-zero
        warm = np.minimum((step + f32(1.0)) / f32(warmup_steps), f32(1.0))
        stairs = np.floor(np.maximum(step - f32(warmup_steps), f32(0.0)) / f32(decay_every))
        return float(f32(peak_lr) * warm * f32(decay_rate) ** stairs)

    return schedule


def global_norm(tree: Tree) -> torch.Tensor:
    norms = torch._foreach_norm([g.float() for g in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Global transform applied after the batch mean; the per-system 0.1
    clip happens inside the train step before it."""

    schedule: Callable[[int], float]
    global_clip: float = 10.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def init(self, params: Tree) -> AdamState:
        zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        return AdamState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    def update(self, grads: Tree, state: AdamState):
        """Returns the updates (to add to the params) and the new state;
        `state`'s moments are updated in place."""
        names = list(grads)
        g = [grads[n] for n in names]
        g_norm = global_norm(grads)
        if not bool(g_norm < self.global_clip):
            g = torch._foreach_div(g, g_norm)
            torch._foreach_mul_(g, self.global_clip)
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        step_size = -self.schedule(state.count)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        m_hat = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_mul_(m_hat, step_size)
        return dict(zip(names, m_hat)), AdamState(count, state.mu, state.nu)


def make_optimizer(peak_lr: float = 1.8e-3, warmup_steps: int = 1000,
                   global_clip: float = 10.0, b1: float = 0.9, b2: float = 0.95,
                   eps: float = 1e-8) -> Optimizer:
    return Optimizer(stair_exp_warmup_schedule(peak_lr, warmup_steps), global_clip, b1, b2, eps)


def clip_by_norm(tree: Tree, max_norm: float) -> Tree:
    """Per-system gradient clip (train.sh --per-sample-clip-norm 0.1)."""
    scale = torch.clamp(max_norm / (global_norm(tree) + 1e-9), max=1.0)
    return dict(zip(tree, torch._foreach_mul(list(tree.values()), scale)))


@torch.no_grad()
def ema_update(ema: Tree, params: Tree, decay: float = 0.999) -> None:
    """ema <- ema * decay + params * (1 - decay), in place."""
    names = list(ema)
    torch._foreach_mul_([ema[n] for n in names], decay)
    torch._foreach_add_([ema[n] for n in names], [params[n].detach().float() for n in names],
                        alpha=1.0 - decay)
