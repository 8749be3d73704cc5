"""EDM reverse-diffusion sampler with inline physics guidance (port of
`physdock_tpu/model/diffusion.py`).

The reverse pass is a Python loop over the sigma schedule; the trunk runs
once per call (or is passed in) and the per-block DiT biases are cached
for all steps.  Guidance per step: conformer-bank distance matching at
high sigma, the restraint-field relaxation (`model/forcefield.py`) at low
sigma, both applied through a weighted rigid alignment of the ligand.
Randomness comes from one `torch.Generator`; `noise_override` replaces
every draw with caller-given arrays (the lockstep-parity hook).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from physdock_tpu_torch.model.forcefield import LigandFF, relax_positions
from physdock_tpu_torch.utils.geometry import (
    apply_centre_augmentation,
    centre_random_augmentation,
    masked_mean,
    smooth_lddt_epsilon,
    weighted_rigid_align,
)

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
    end, so gathers clamp and scatters drop them."""

    ligand_idx: torch.Tensor  # [L] int64
    ligand_mask: torch.Tensor  # [L] float
    conf_pos: torch.Tensor  # [C, L, 3]
    conf_dists: torch.Tensor  # [C, L, L]
    conf_mask: torch.Tensor  # [C] float -- valid conformers
    ff: Optional[LigandFF] = None


def select_best_conformers(ligand_pos: torch.Tensor, guidance: PhysicsGuidance
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match each sample's ligand distance matrix against the conformer bank
    with the 4-sigmoid epsilon; returns (best_idx [S], conf_pos [S, L, 3])."""
    lig_d = torch.linalg.norm(ligand_pos[:, :, None] - ligand_pos[:, None] + 1e-12, dim=-1)
    delta = torch.abs(lig_d[:, None] - guidance.conf_dists[None])  # [S, C, L, L]
    eps = smooth_lddt_epsilon(delta)
    pair_mask = guidance.ligand_mask[:, None] * guidance.ligand_mask[None, :]
    score = masked_mean(pair_mask[None, None], eps, dim=(-1, -2))  # [S, C]
    score = torch.where(guidance.conf_mask[None] > 0, score,
                        torch.tensor(float("inf"), device=score.device))
    best = torch.argmin(score, dim=-1)
    return best, guidance.conf_pos[best]


def _gather_ligand(x, guidance):
    idx = guidance.ligand_idx.clamp(max=x.shape[-2] - 1)
    return x[..., idx, :]


def _scatter_ligand(x, lig, guidance):
    keep = guidance.ligand_idx < x.shape[-2]
    out = x.clone()
    out[..., guidance.ligand_idx[keep], :] = lig[..., keep, :].to(x.dtype)
    return out


@torch.no_grad()
def sample_diffusion(
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
    mmff_gamma_0_factor: float = 1.0,
    mmff_iters: int = 5,
    align_ref_pos: bool = True,
    conditioning: Optional[Tuple] = None,
    noise_override: Optional[Dict[str, torch.Tensor]] = None,
    return_trajectory: bool = False,
) -> torch.Tensor:
    """Run the EDM reverse pass; returns x [num_sample, A, 3] (or the
    trajectory [steps, num_sample, A, 3]).

    noise_override keys: x_init_z [S, A, 3], aug_R [T, S, 3, 3],
    aug_t [T, S, 3], churn_z [T, S, A, 3]."""
    x_exists = batch["a_mask"].float()
    dev = x_exists.device
    num_atoms = batch["ref_pos"].shape[-2]

    if conditioning is None:
        conditioning = model.conditioning(batch)
    a, ap, s, z = conditioning
    bias_cache = model.denoise_bias_cache(batch, ap, z)

    sig_np = karras_noise_schedule(steps, model.cfg.sigma_data, s_max, s_min, karras_rho)
    sigmas = torch.as_tensor(sig_np, device=dev)
    is_ligand_atom = (
        torch.index_select(batch["is_ligand"].float(), -1, batch["atom_id_to_token_id"]) * x_exists
    )

    if noise_override is not None:
        x_next = sigmas[0] * noise_override["x_init_z"].to(dev).float()
    else:
        x_next = sigmas[0] * torch.randn((num_sample, num_atoms, 3), generator=generator,
                                         device=dev)
    batch_ref_pos = batch["ref_pos"].float()[None].repeat(num_sample, 1, 1)

    has_conf = guidance is not None and align_ref_pos
    has_ff = guidance is not None and guidance.ff is not None
    thresh = gamma_min * mmff_gamma_0_factor
    w = is_ligand_atom
    traj = []
    for i in range(steps):
        t_cur, t_next = sigmas[i], sigmas[i + 1]
        t_cur_f = float(sig_np[i])
        if noise_override is not None:
            x_cur = apply_centre_augmentation(
                x_next, x_exists, noise_override["aug_R"][i].to(dev).float(),
                noise_override["aug_t"][i].to(dev).float())
        else:
            x_cur = centre_random_augmentation(x_next, x_exists, generator)

        churn = t_cur_f > gamma_min
        if churn:
            t_hat_churn = t_cur * (gamma_0 + 1.0)
            if noise_override is not None:
                noise = noise_override["churn_z"][i].to(dev).to(x_cur.dtype)
            else:
                noise = torch.randn(x_cur.shape, generator=generator, device=dev,
                                    dtype=x_cur.dtype)
            ksi = noise_scale_lambda * noise * torch.sqrt(
                torch.clamp(t_hat_churn**2 - t_cur**2, min=0.0))
            t_hat = t_hat_churn * torch.ones((num_sample,), device=dev)
            x_hat = x_cur + ksi
        else:
            t_hat = t_cur * torch.ones((num_sample,), device=dev)
            x_hat = x_cur

        x_denoised = model.denoise(batch, x_hat, t_hat, a, ap, s, z, bias_cache)
        th = t_hat[:, None, None]
        d_cur = (x_hat - x_denoised) / th

        use_conf = has_conf and t_cur_f > thresh
        use_ff = has_ff and t_cur_f <= thresh
        target = None
        if use_conf:
            _, best_conf = select_best_conformers(_gather_ligand(x_denoised, guidance), guidance)
            batch_ref_pos = _scatter_ligand(batch_ref_pos, best_conf, guidance)
            target = batch_ref_pos
        elif use_ff:
            lig_relaxed = relax_positions(_gather_ligand(x_denoised, guidance), guidance.ff,
                                          iters=mmff_iters)
            target = _scatter_ligand(x_denoised, lig_relaxed, guidance)
        if target is not None:
            ligand_denoised = weighted_rigid_align(x_denoised * x_exists[..., None], target, w)
            d_lig = (x_hat - ligand_denoised) / th * w[None, :, None]
            d_cur = d_cur * (1.0 - w[None, :, None]) + d_lig

        eta = step_scale_eta if churn else ode_step_scale_eta
        x_next = x_hat + eta * (t_next - t_hat)[:, None, None] * d_cur
        if return_trajectory:
            traj.append(x_next)
    return torch.stack(traj) if return_trajectory else x_next
