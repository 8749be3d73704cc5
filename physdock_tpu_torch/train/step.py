"""One training step, on one device or over a dp x tp mesh of processes
(port of `physdock_tpu/train/step.py`).

For each system of this rank's batch: forward, loss and backward; under
tp the ranks of a replica share one system and `parallel/tp.py::
reduce_grads` sums their shares of its gradient.  That system's gradient
is clipped to 0.1 by its global norm (the reference's per-sample clip,
train.sh --per-sample-clip-norm) before any reduction over dp, and added
to an fp32 accumulator.  Then one flat fp32 all-reduce (SUM) over the dp
group carries the accumulated gradients and the loss logs together, and
the sum is divided by the global batch n_local * dp (the JAX step's psum
over `dp`, train.sh --allreduce-fp32-grad).  DDP's hooks would reduce
the gradient before the clip, so the step reduces by hand.  Then every
rank runs the same optimizer (global clip 10, Adam, schedule) and EMA on
the same gradient.  Without a process group (one card) no collective
runs.

With `use_mini_rollout` (loss_module3.py:599-610, train.sh
--mini-rollout-steps 12) the forward also returns the trunk's
conditioning; a short EDM rollout of one sample runs from it without
gradient (or, with `corrupt_rollout_pose`, a corrupted GT pose stands in
for the rollout: `train/corrupt.py`), the confidence head scores that pose
from the trunk's s and z, and `rffold_loss` adds the pLDDT, PAE and PDE
losses.  Their gradients reach the trunk through s and z, as in the JAX
package; the pose carries none.

Every random draw of a system comes from streams keyed by the run's seed,
the step (`state.step`), the system's global index (`dp_rank * n_local +
i`, the JAX step's fold) and the purpose (`train/draws.py`): its x_hat
and t_hat from the forward's stream, the rollout's noise or the
corruption's draws from their own, as the JAX step splits the system's
key into `k_fwd` and `k_roll` (`draw_system`). Each rank draws its own
systems only, the tp ranks of a replica alike, and the dp=N step equals
the dp=1 step on the same global batch. `train_step(..., draws=...)`
takes the draws given instead.

With `cuda_graph` (one card, the plain step) the forward and backward of
each system are CUDA graphs, one pair per input shape
(`torch.cuda.make_graphed_callables` over `model.forward_noised`): the
same kernels in the same order, replayed without the host's cost of some
ten thousand launches a system. The loss (its Kabsch SVD synchronizes),
the clips, Adam and the EMA stay eager. A CPU batch takes the eager path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from physdock_tpu_torch.config import LossConfig
from physdock_tpu_torch.model.diffusion import sample_diffusion
from physdock_tpu_torch.model.losses import physdock_loss, rffold_loss
from physdock_tpu_torch.model.physdock import prepare_batch
from physdock_tpu_torch.parallel.mesh import Mesh, all_reduce_
from physdock_tpu_torch.parallel.tp import reduce_grads, use_tp
from physdock_tpu_torch.train import draws as keyed
from physdock_tpu_torch.train.corrupt import corrupt_pose_draws, corrupt_pose_from_draws
from physdock_tpu_torch.train.optim import AdamState, Optimizer, clip_by_norm, ema_update
from physdock_tpu_torch.utils.geometry import take_rows, uniform_random_rotation
from physdock_tpu_torch.utils.profiling import span

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


class _Denoiser(torch.nn.Module):
    """`model.forward_noised` over flat tensors (a graphed callable takes
    only tensors), returning what the plain loss reads of it."""

    def __init__(self, model, keys):
        super().__init__()
        self.model, self.keys = model, keys

    def forward(self, x_hat, t_hat, *values):
        out = self.model.forward_noised(dict(zip(self.keys, values)), x_hat, t_hat)
        return out["x_denoised"], out["p_distogram"]


def make_train_step(model, optimizer: Optimizer, loss_cfg: LossConfig,
                    per_replica_clip: float = 0.1, ema_decay: float = 0.999,
                    sigma_data: float = 16.0, use_mini_rollout: bool = False,
                    mini_rollout_steps: int = 12, corrupt_rollout_pose: bool = False,
                    mesh: Optional[Mesh] = None, cuda_graph: bool = False):
    """Build `train_step(state, batch, seed, draws=None) -> (state, logs)`.

    batch: dict of tensors on the model's device with a leading axis of
    this rank's n_local systems (the global batch is the dp ranks' in
    rank order; the tp ranks of a replica get the same systems); `seed`,
    the run's, keys every system's draws with the step and the system's
    global index, unless `draws` gives each system's of the global batch
    (`draw_system`'s keys). logs are the global batch means of the loss
    terms, as floats, the same on every rank."""
    if cuda_graph and (use_mini_rollout or mesh is not None):
        raise ValueError("cuda_graph covers the plain step in one process")
    dp = 1 if mesh is None else mesh.dp
    dp_rank = 0 if mesh is None else mesh.dp_rank
    graphed: Dict[tuple, object] = {}

    def forward_noised(micro: Tree, x_hat, t_hat) -> Tree:
        """The model's forward without its conditioning: eager, or the
        graphed callable of this input shape (captured at its first call)."""
        if not cuda_graph or x_hat.device.type != "cuda":
            out = model.forward_noised(micro, x_hat, t_hat)
            out.pop("conditioning")
            return out
        keys = sorted(micro)
        values = (x_hat, t_hat, *(micro[k] for k in keys))
        sig = tuple((tuple(v.shape), v.dtype) for v in values) + tuple(keys)
        if sig not in graphed:
            graphed[sig] = torch.cuda.make_graphed_callables(
                _Denoiser(model, keys), tuple(v.clone() for v in values),
                allow_unused_input=True)
        x_denoised, p_distogram = graphed[sig](*values)
        return {"x_denoised": x_denoised, "x_hat": x_hat, "t_hat": t_hat,
                "p_distogram": p_distogram}

    def draw_system(micro: Tree, seed: int, step: int, index: int) -> Dict:
        """The draws of global system `index` in step `step` of the run
        seeded `seed`."""
        x_hat, t_hat = model.augmentation_diffuse(micro, keyed.stream(seed, step, index, "forward"))
        d = {"x_hat": x_hat, "t_hat": t_hat}
        n_atoms = micro["x_gt"].shape[-2]
        if use_mini_rollout and corrupt_rollout_pose:
            d["corrupt"] = corrupt_pose_draws(keyed.stream(seed, step, index, "corrupt"), n_atoms)
        elif use_mini_rollout:
            d["rollout"] = rollout_draws(keyed.stream(seed, step, index, "rollout"), n_atoms,
                                         mini_rollout_steps)
        return d

    @span("physdock.train.forward")
    def loss_fn(micro: Tree, d: Dict):
        if not use_mini_rollout:
            out = forward_noised(micro, d["x_hat"], d["t_hat"])
            with span("physdock.train.forward.loss"):
                return physdock_loss(out, micro, loss_cfg, sigma_data=sigma_data)
        out = model.forward_noised(micro, d["x_hat"], d["t_hat"])
        a, ap, s, z = out.pop("conditioning")
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
        with span("physdock.train.forward.loss"):
            return rffold_loss(out, micro, loss_cfg, sigma_data=sigma_data,
                               use_mini_rollout=True)

    @span("physdock.train.step")
    def train_step(state: TrainState, batch: Tree, seed: Optional[int] = None,
                   draws: Optional[List[Dict]] = None):
        names = list(state.params)
        leaves = [state.params[n] for n in names]
        n_local = next(iter(batch.values())).shape[0]
        micros = [prepare_batch({k: v[i] for k, v in batch.items()}) for i in range(n_local)]
        first = dp_rank * n_local
        if draws is not None:
            draws = draws[first:first + n_local]
        elif seed is None:
            raise ValueError("train_step needs the run's seed or the draws")
        else:
            with span("physdock.train.draw"):
                draws = [draw_system(m, seed, state.step, first + i)
                         for i, m in enumerate(micros)]
        grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in state.params.items()}
        logs_sum: Dict[str, torch.Tensor] = {}
        for i, micro in enumerate(micros):
            with use_tp(mesh):
                loss, logs = loss_fn(micro, draws[i])
                with span("physdock.train.backward"):
                    g = torch.autograd.grad(loss, leaves, allow_unused=True)
            with span("physdock.train.clip"):
                g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
                reduce_grads(g, mesh)
                clipped = clip_by_norm(dict(zip(names, g)), per_replica_clip)
                torch._foreach_add_([grads[n] for n in names],
                                    [clipped[n].float() for n in names])
                for k, v in logs.items():
                    logs_sum[k] = logs_sum.get(k, 0.0) + v.detach().float()
        with span("physdock.train.update"):
            keys = list(logs_sum)
            if mesh is not None and mesh.dp_group is not None:
                # one flat fp32 all-reduce of the gradients and the logs
                flat = torch.cat([grads[n].reshape(-1) for n in names]
                                 + [logs_sum[k].reshape(1) for k in keys])
                all_reduce_(flat, mesh.dp_group)
                parts = torch.split(flat, [grads[n].numel() for n in names] + [1] * len(keys))
                for n, part in zip(names, parts):
                    grads[n].copy_(part.view_as(grads[n]))
                logs_sum = {k: part[0] for k, part in zip(keys, parts[len(names):])}
            total = n_local * dp
            torch._foreach_div_(list(grads.values()), total)
            with span("physdock.train.update.adam"):
                updates, opt_state = optimizer.update(grads, state.opt_state)
            with torch.no_grad():
                torch._foreach_add_([state.params[n] for n in names],
                                    [updates[n] for n in names])
            with span("physdock.train.update.ema"):
                ema_update(state.ema_params, state.params, ema_decay)
            state = dataclasses.replace(state, step=state.step + 1, opt_state=opt_state)
            with span("physdock.train.update.logs"):
                logs = {k: float(logs_sum[k]) / total for k in keys}
        return state, logs

    # the pieces, for callers that want one system's loss and gradient alone
    train_step.draw_system = draw_system
    train_step.loss_fn = loss_fn
    return train_step
