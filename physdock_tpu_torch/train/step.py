"""One training step on one device (port of `physdock_tpu/train/step.py`).

For each system of the batch: forward, loss and backward; that system's
gradient is clipped to 0.1 by its global norm (the reference's
per-sample clip, train.sh --per-sample-clip-norm) and added to an fp32
accumulator.  The sum is divided by the batch size, then the optimizer
(global clip 10, Adam, schedule) and the EMA run.  The `dp` mesh of the
JAX step waits for the multi-GPU slice.

With `use_mini_rollout` (loss_module3.py:599-610, train.sh
--mini-rollout-steps 12) the forward also returns the trunk's
conditioning; a short EDM rollout of one sample runs from it without
gradient (or, with `corrupt_rollout_pose`, a corrupted GT pose stands in
for the rollout: `train/corrupt.py`), the confidence head scores that pose
from the trunk's s and z, and `rffold_loss` adds the pLDDT, PAE and PDE
losses.  Their gradients reach the trunk through s and z, as in the JAX
package; the pose carries none.

Every random draw of a system (its x_hat and t_hat, and the rollout's
noise or the corruption's draws) comes from one CPU `torch.Generator`, in
that order (`draw_system`), so a card run and a CPU run from one seed see
the same numbers; `train_step(..., draws=...)` takes them given instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from physdock_tpu_torch.config import LossConfig
from physdock_tpu_torch.model.diffusion import sample_diffusion
from physdock_tpu_torch.model.losses import physdock_loss, rffold_loss
from physdock_tpu_torch.model.physdock import prepare_batch
from physdock_tpu_torch.train.corrupt import corrupt_pose_draws, corrupt_pose_from_draws
from physdock_tpu_torch.train.optim import AdamState, Optimizer, clip_by_norm, ema_update
from physdock_tpu_torch.utils.geometry import take_rows, uniform_random_rotation

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


def rollout_draws(generator: Optional[torch.Generator], n_atoms: int, steps: int
                  ) -> Dict[str, torch.Tensor]:
    """The noise of a one-sample rollout of `steps` steps, on the CPU, in
    `sample_diffusion`'s `noise_override` layout."""
    return {
        "x_init_z": torch.randn((1, n_atoms, 3), generator=generator),
        "aug_R": uniform_random_rotation((steps, 1), generator, "cpu"),
        "aug_t": torch.randn((steps, 1, 3), generator=generator),
        "churn_z": torch.randn((steps, 1, n_atoms, 3), generator=generator),
    }


def make_train_step(model, optimizer: Optimizer, loss_cfg: LossConfig,
                    per_replica_clip: float = 0.1, ema_decay: float = 0.999,
                    sigma_data: float = 16.0, use_mini_rollout: bool = False,
                    mini_rollout_steps: int = 12, corrupt_rollout_pose: bool = False):
    """Build `train_step(state, batch, generator, draws=None) -> (state,
    logs)`.

    batch: dict of tensors on the model's device with a leading system
    axis; `generator` (a CPU `torch.Generator`) draws every system's
    noise, unless `draws` gives each system's (`draw_system`'s keys).
    logs are the batch means of the loss terms, as floats."""

    def draw_system(micro: Tree, generator) -> Dict:
        x_hat, t_hat = model.augmentation_diffuse(micro, generator)
        d = {"x_hat": x_hat, "t_hat": t_hat}
        n_atoms = micro["x_gt"].shape[-2]
        if use_mini_rollout and corrupt_rollout_pose:
            d["corrupt"] = corrupt_pose_draws(generator, n_atoms)
        elif use_mini_rollout:
            d["rollout"] = rollout_draws(generator, n_atoms, mini_rollout_steps)
        return d

    def loss_fn(micro: Tree, d: Dict):
        out = model.forward_noised(micro, d["x_hat"], d["t_hat"])
        a, ap, s, z = out.pop("conditioning")
        if not use_mini_rollout:
            return physdock_loss(out, micro, loss_cfg, sigma_data=sigma_data)
        if corrupt_rollout_pose:
            # a corrupted GT pose instead of a rollout: spans the label bins
            # even when the denoiser is memorized
            a_mask = micro["a_mask"].float()
            is_lig_atom = take_rows(micro["is_ligand"].float(), micro["atom_id_to_token_id"],
                                    dim=-1) * a_mask
            x_pred = corrupt_pose_from_draws(micro["x_gt"].float(), a_mask, is_lig_atom,
                                             d["corrupt"])
        else:
            with torch.no_grad():
                x_pred = sample_diffusion(
                    model, micro, num_sample=1, steps=mini_rollout_steps,
                    conditioning=tuple(t.detach() for t in (a, ap, s, z)),
                    noise_override=d["rollout"])
        p_pae, p_pde, p_plddt = model.confidence(micro, s, z, x_pred)
        out.update(x_pred=x_pred, p_pae=p_pae, p_pde=p_pde, p_plddt=p_plddt)
        return rffold_loss(out, micro, loss_cfg, sigma_data=sigma_data, use_mini_rollout=True)

    def train_step(state: TrainState, batch: Tree, generator: Optional[torch.Generator] = None,
                   draws: Optional[List[Dict]] = None):
        names = list(state.params)
        leaves = [state.params[n] for n in names]
        n_sys = next(iter(batch.values())).shape[0]
        grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in state.params.items()}
        logs_sum: Dict[str, torch.Tensor] = {}
        for i in range(n_sys):
            micro = prepare_batch({k: v[i] for k, v in batch.items()})
            d = draws[i] if draws is not None else draw_system(micro, generator)
            loss, logs = loss_fn(micro, d)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = {n: torch.zeros_like(p) if gi is None else gi
                 for n, p, gi in zip(names, leaves, g)}
            clipped = clip_by_norm(g, per_replica_clip)
            torch._foreach_add_([grads[n] for n in names], [clipped[n].float() for n in names])
            for k, v in logs.items():
                logs_sum[k] = logs_sum.get(k, 0.0) + v.detach().float()
        torch._foreach_div_(list(grads.values()), n_sys)
        updates, opt_state = optimizer.update(grads, state.opt_state)
        with torch.no_grad():
            torch._foreach_add_([state.params[n] for n in names], [updates[n] for n in names])
        ema_update(state.ema_params, state.params, ema_decay)
        state = dataclasses.replace(state, step=state.step + 1, opt_state=opt_state)
        return state, {k: float(v) / n_sys for k, v in logs_sum.items()}

    # the pieces, for callers that want one system's loss and gradient alone
    train_step.draw_system = draw_system
    train_step.loss_fn = loss_fn
    return train_step
