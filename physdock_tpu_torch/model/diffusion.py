"""EDM reverse-diffusion sampler with inline physics guidance (port of
`physdock_tpu/model/diffusion.py`).

The reverse pass is a Python loop over the sigma schedule; the trunk runs
once per call (or is passed in) and the per-block DiT biases are cached
for all steps.  Guidance per step: conformer-bank distance matching at
high sigma, the restraint-field relaxation (`model/forcefield.py`) at low
sigma, both applied through a weighted rigid alignment of the ligand.
Randomness comes from one `torch.Generator`; `noise_override` replaces
every draw with caller-given arrays (the lockstep-parity hook).  Every
draw is made for all `num_sample` poses; `sample_range` runs a slice of
them, each pose with the very draws it gets in the whole pass (the dp
shard of `infer/sharded.py`).

`sample_diffusion_batched` runs several ligand-systems of one shape in
one pass, every input with a leading system axis (what `jax.vmap` of the
JAX sampler takes): per-system conditioning, guidance, adaptive factor
and noise, with the denoiser's attention launched once per block and step
for the whole group.  `sample_diffusion` is the same pass for one system.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from physdock_tpu_torch.model.forcefield import LigandFF, relax_positions, stack_ligand_ffs
from physdock_tpu_torch.utils.geometry import (
    apply_centre_augmentation,
    masked_mean,
    smooth_lddt_epsilon,
    take_rows,
    uniform_random_rotation,
    weighted_rigid_align,
)
from physdock_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def karras_noise_schedule(num_steps: int, sigma_data: float = 16.0, s_max: float = 160.0,
                          s_min: float = 4e-3, rho: float = 7.0) -> np.ndarray:
    """Karras sigma schedule with a trailing zero (host numpy, float32)."""
    i = np.arange(num_steps, dtype=np.float64)
    denom = max(num_steps - 1, 1)
    t = sigma_data * (
        s_max ** (1 / rho) + i / denom * (s_min ** (1 / rho) - s_max ** (1 / rho))
    ) ** rho
    return np.concatenate([t, [0.0]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PhysicsGuidance:
    """Physics-guidance inputs (static shapes). ligand_idx: [L] indices of
    ligand atoms in the padded atom axis; padded entries point one past the
    end, so gathers clamp and scatters drop them. `stack_guidances` puts
    several systems' guidance on a leading system axis ([Bsys, L], ...)."""

    ligand_idx: torch.Tensor  # [L] int64
    ligand_mask: torch.Tensor  # [L] float
    conf_pos: torch.Tensor  # [C, L, 3]
    conf_dists: torch.Tensor  # [C, L, L]
    conf_mask: torch.Tensor  # [C] float -- valid conformers
    ff: Optional[LigandFF] = None


def stack_guidances(guidances: Sequence[PhysicsGuidance]) -> PhysicsGuidance:
    """Stack same-shaped guidances (ligand axes padded alike) on a leading
    system axis; the force fields through `stack_ligand_ffs`."""
    fields = {f.name: torch.stack([getattr(g, f.name) for g in guidances])
              for f in dataclasses.fields(PhysicsGuidance) if f.name != "ff"}
    ffs = [g.ff for g in guidances]
    return PhysicsGuidance(**fields, ff=None if ffs[0] is None else stack_ligand_ffs(ffs))


def select_best_conformers(ligand_pos: torch.Tensor, guidance: PhysicsGuidance
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match each sample's ligand distance matrix against its system's
    conformer bank with the 4-sigmoid epsilon. ligand_pos [Bsys, S, L, 3]
    and stacked guidance; returns (best_idx [Bsys, S], conf_pos [Bsys, S,
    L, 3])."""
    lig_d = torch.linalg.norm(ligand_pos[..., :, None, :] - ligand_pos[..., None, :, :] + 1e-12,
                              dim=-1)
    delta = torch.abs(lig_d[:, :, None] - guidance.conf_dists[:, None])  # [B, S, C, L, L]
    eps = smooth_lddt_epsilon(delta)
    lm = guidance.ligand_mask
    pair_mask = lm[:, :, None] * lm[:, None, :]
    score = masked_mean(pair_mask[:, None, None], eps, dim=(-1, -2))  # [B, S, C]
    score = torch.where(guidance.conf_mask[:, None] > 0, score,
                        torch.tensor(float("inf"), device=score.device))
    best = torch.argmin(score, dim=-1)
    return best, torch.take_along_dim(guidance.conf_pos, best[..., None, None], dim=1)


def gather_ligand(x, guidance):
    """[Bsys, ..., A, 3] -> [Bsys, ..., L, 3] per system (pads clamp)."""
    idx = guidance.ligand_idx.clamp(max=x.shape[-2] - 1)
    return take_rows(x, idx.view(idx.shape[:1] + (1,) * (x.dim() - 3) + idx.shape[1:]))


def _scatter_ligand(x, lig, guidance):
    """x with each system's ligand rows set from lig; padded indices (one
    past the end) land in a dropped extra row."""
    idx = guidance.ligand_idx
    idx = idx.view(idx.shape[:1] + (1,) * (x.dim() - 3) + idx.shape[1:])[..., None]
    out = torch.cat([x, x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))], dim=-2)
    out.scatter_(-2, idx.expand(*lig.shape), lig.to(x.dtype))
    return out[..., :-1, :]


def _where_systems(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a for the systems where mask [Bsys] holds, b for the others."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


@torch.no_grad()
def sample_diffusion(model, batch: Batch, *, guidance: Optional[PhysicsGuidance] = None,
                     mmff_gamma_0_factor: float = 1.0, conditioning: Optional[Tuple] = None,
                     noise_override: Optional[Dict[str, torch.Tensor]] = None,
                     **kw) -> torch.Tensor:
    """The EDM reverse pass for one system: `sample_diffusion_batched` over
    a system axis of one. Returns x [num_sample, A, 3] (or the trajectory
    [steps, num_sample, A, 3]).

    noise_override keys: x_init_z [S, A, 3], aug_R [T, S, 3, 3],
    aug_t [T, S, 3], churn_z [T, S, A, 3]."""
    one = lambda t: t[None]  # noqa: E731
    return sample_diffusion_batched(
        model, {k: one(v) for k, v in batch.items()},
        guidance=None if guidance is None else stack_guidances([guidance]),
        mmff_gamma_0_factor=[float(mmff_gamma_0_factor)],
        conditioning=None if conditioning is None else tuple(map(one, conditioning)),
        noise_override=None if noise_override is None else {
            k: one(v) for k, v in noise_override.items()},
        **kw)[0]


def stacked_conditioning(model, batch: Batch) -> Tuple:
    """The trunk's (a, ap, s, z) of every system of a stacked batch, one
    system at a time, stacked on the system axis."""
    n = batch["a_mask"].shape[0]
    outs = [model.conditioning({k: v[b] for k, v in batch.items()}) for b in range(n)]
    return tuple(torch.stack(x) for x in zip(*outs))


@torch.no_grad()
@span("physdock.sampler")
def sample_diffusion_batched(
    model,
    batch: Batch,
    *,
    generator: Optional[torch.Generator] = None,
    num_sample: int = 5,
    steps: int = 40,
    gamma_0: float = 0.8,
    gamma_min: float = 1.0,
    noise_scale_lambda: float = 1.003,
    step_scale_eta: float = 1.5,
    ode_step_scale_eta: float = 1.0,
    karras_rho: float = 7.0,
    s_max: float = 160.0,
    s_min: float = 4e-3,
    guidance: Optional[PhysicsGuidance] = None,
    mmff_gamma_0_factor: Sequence[float] = (1.0,),
    mmff_iters: int = 5,
    align_ref_pos: bool = True,
    conditioning: Optional[Tuple] = None,
    noise_override: Optional[Dict[str, torch.Tensor]] = None,
    return_trajectory: bool = False,
    sample_range: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Run the EDM reverse pass for Bsys systems of one shape at once.
    batch, conditioning, guidance (`stack_guidances`) and noise_override
    lead with the system axis; mmff_gamma_0_factor holds one factor per
    system. Returns x [Bsys, num_sample, A, 3] (or the trajectory [Bsys,
    steps, num_sample, A, 3]).

    noise_override keys: x_init_z [Bsys, S, A, 3], aug_R [Bsys, T, S, 3,
    3], aug_t [Bsys, T, S, 3], churn_z [Bsys, T, S, A, 3]; system b then
    draws exactly what a single-system run given its slices draws.

    sample_range (lo, hi) returns poses lo..hi-1 of the num_sample
    ([Bsys, hi - lo, A, 3]), drawn and sliced from the whole pass's
    draws."""
    x_exists = batch["a_mask"].float()  # [B, A]
    n_sys, num_atoms = x_exists.shape
    dev = x_exists.device
    exists = x_exists[:, None]  # [B, 1, A]: against poses [B, S, A, 3]

    if conditioning is None:
        conditioning = stacked_conditioning(model, batch)
    a, ap, s, z = conditioning
    bias_cache = model.denoise_bias_cache(batch, ap, z)

    sig_np = karras_noise_schedule(steps, model.cfg.sigma_data, s_max, s_min, karras_rho)
    sigmas = torch.as_tensor(sig_np, device=dev)
    is_ligand_atom = take_rows(batch["is_ligand"].float(), batch["atom_id_to_token_id"],
                               dim=-1) * x_exists
    w = is_ligand_atom[:, None, :, None]  # [B, 1, A, 1]

    lo, hi = sample_range or (0, num_sample)
    full, shape = (n_sys, num_sample), (n_sys, hi - lo)

    def mine(x):  # this call's poses of a draw or override [Bsys, num_sample, ...]
        return x[:, lo:hi]

    if noise_override is not None:
        x_next = sigmas[0] * mine(noise_override["x_init_z"]).to(dev).float()
    else:
        x_next = sigmas[0] * mine(torch.randn(full + (num_atoms, 3), generator=generator,
                                              device=dev))
    batch_ref_pos = batch["ref_pos"].float()[:, None].repeat(1, hi - lo, 1, 1)

    has_conf = guidance is not None and align_ref_pos
    has_ff = guidance is not None and guidance.ff is not None
    factors = [float(f) for f in mmff_gamma_0_factor]
    if len(factors) != n_sys:
        raise ValueError(f"{len(factors)} mmff factors for {n_sys} systems")
    # per step and system: conformer matching above the system's threshold,
    # the restraint field at or below it (the JAX sampler's selects), decided
    # on the host and copied to the card once
    conf_on = [[has_conf and float(t) > gamma_min * f for f in factors] for t in sig_np[:-1]]
    ff_on = [[has_ff and float(t) <= gamma_min * f for f in factors] for t in sig_np[:-1]]
    conf_sel, ff_sel = torch.tensor([conf_on, ff_on], device=dev).reshape(2, steps, n_sys)
    traj = []
    for i in range(steps):
        with span("physdock.sampler.step"):
            t_cur, t_next = sigmas[i], sigmas[i + 1]
            t_cur_f = float(sig_np[i])
            if noise_override is not None:
                rot = mine(noise_override["aug_R"][:, i]).to(dev).float()
                trans = mine(noise_override["aug_t"][:, i]).to(dev).float()
            else:  # centre_random_augmentation's draws, for every pose
                rot = mine(uniform_random_rotation(full, generator, dev))
                trans = mine(torch.randn(full + (3,), generator=generator, device=dev,
                                         dtype=x_next.dtype))
            x_cur = apply_centre_augmentation(x_next, exists, rot, trans)

            churn = t_cur_f > gamma_min
            if churn:
                t_hat_churn = t_cur * (gamma_0 + 1.0)
                if noise_override is not None:
                    noise = mine(noise_override["churn_z"][:, i]).to(dev).to(x_cur.dtype)
                else:
                    noise = mine(torch.randn(full + (num_atoms, 3), generator=generator, device=dev,
                                             dtype=x_cur.dtype))
                ksi = noise_scale_lambda * noise * torch.sqrt(
                    torch.clamp(t_hat_churn**2 - t_cur**2, min=0.0))
                t_hat = t_hat_churn * torch.ones(shape, device=dev)
                x_hat = x_cur + ksi
            else:
                t_hat = t_cur * torch.ones(shape, device=dev)
                x_hat = x_cur

            x_denoised = model.denoise(batch, x_hat, t_hat, a, ap, s, z, bias_cache)
            th = t_hat[..., None, None]
            d_cur = (x_hat - x_denoised) / th

            use_conf, use_ff = conf_sel[i], ff_sel[i]
            target = None
            if any(conf_on[i]):
                with span("physdock.step.conformers"):
                    _, best_conf = select_best_conformers(gather_ligand(x_denoised, guidance),
                                                          guidance)
                    new_ref = _scatter_ligand(batch_ref_pos, best_conf, guidance)
                    batch_ref_pos = _where_systems(use_conf, new_ref, batch_ref_pos)
                target = batch_ref_pos
            if any(ff_on[i]):
                with span("physdock.step.relax"):
                    lig_relaxed = relax_positions(gather_ligand(x_denoised, guidance), guidance.ff,
                                                  iters=mmff_iters)
                    x_ref_ff = _scatter_ligand(x_denoised, lig_relaxed, guidance)
                target = x_ref_ff if target is None else _where_systems(
                    use_conf, batch_ref_pos, x_ref_ff)
            if target is not None:
                with span("physdock.step.align"):
                    ligand_denoised = weighted_rigid_align(x_denoised * exists[..., None], target,
                                                           is_ligand_atom)
                    d_lig = (x_hat - ligand_denoised) / th * w
                    d_guided = d_cur * (1.0 - w) + d_lig
                    d_cur = _where_systems(use_conf | use_ff, d_guided, d_cur)

            eta = step_scale_eta if churn else ode_step_scale_eta
            x_next = x_hat + eta * (t_next - t_hat)[..., None, None] * d_cur
            if return_trajectory:
                traj.append(x_next)
    return torch.stack(traj, dim=1) if return_trajectory else x_next
