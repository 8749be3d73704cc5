"""The PhysDock model: conditioning trunk + AF3DiT denoiser + distogram
head, and the optional confidence head (port of
`physdock_tpu/model/physdock.py`).

  * `forward(batch, generator)` -- the training forward: EDM-noise
    `num_augmentation_sample` augmented copies of x_gt and denoise them all;
    returns {x_denoised, x_hat, t_hat, p_distogram} and the trunk's
    (a, ap, s, z) under `conditioning`
  * `forward_noised(batch, x_hat, t_hat)` -- the same from given noise (the
    seam through which tests feed the JAX package's x_hat / t_hat)
  * `confidence(batch, s, z, x_pred)` -- the PAE/PDE/pLDDT logits of a
    pose (`with_confidence=True` only)
  * `conditioning(batch)` -- (a, ap, s, z), once per system and round
  * `denoise_bias_cache(batch, ap, z)` -- per-block DiT biases, once per round
  * `denoise(batch, x_hat, t_hat, a, ap, s, z, bias_cache)` -- one denoiser call
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from physdock_tpu_torch.config import ModelConfig
from physdock_tpu_torch.model.compact import expand_batch
from physdock_tpu_torch.nn.conditioning import DiffusionConditioning
from physdock_tpu_torch.nn.confidence import ConfidenceModule
from physdock_tpu_torch.nn.primitives import Linear
from physdock_tpu_torch.nn.transformers import AF3DiT
from physdock_tpu_torch.utils.geometry import (
    apply_centre_augmentation,
    uniform_random_rotation,
)

Batch = Dict[str, torch.Tensor]


def prepare_batch(batch: Batch) -> Batch:
    """Expand compact int8 transport features + derive the pair masks (both
    no-ops when the batch already carries the fat f32 forms)."""
    batch = expand_batch(batch)
    if "z_mask" in batch and "ap_mask" in batch:
        return batch
    batch = dict(batch)
    if "z_mask" not in batch:
        s = batch["s_mask"].float()
        batch["z_mask"] = s[..., :, None] * s[..., None, :]
    if "ap_mask" not in batch:
        a = batch["a_mask"].float()
        batch["ap_mask"] = a[..., :, None] * a[..., None, :]
    return batch


class PhysDock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, generator=None,
                 with_confidence: bool = False):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.with_confidence = with_confidence
        skw = dict(inf=c.inf, eps=c.eps, dtype=dtype, generator=generator)
        self.diffusion_conditioning = DiffusionConditioning(
            c.ref_dim, c.target_dim, c.msa_dim, c.c_a, c.c_ap, c.c_s, c.c_m, c.c_z,
            c.no_blocks_atom, c.no_blocks_evoformer, c.no_blocks_pairformer,
            c.no_blocks_template, c.num_recycles, **skw)
        self.dit = AF3DiT(c.c_a, c.c_ap, c.c_s, c.c_z, c.no_blocks_atom, c.no_blocks_dit,
                          c.sigma_data, **skw)
        # the distogram head is training-only (`forward`)
        self.linear_distogram = Linear(c.c_z, c.no_distogram_bins, init="final", dtype=dtype,
                                       generator=generator)
        if with_confidence:
            # made last, so a model without the head draws the same weights
            self.confidence_module = ConfidenceModule(
                c.c_s, c.c_a, c.c_ap, c.c_z, c.no_blocks_heads, c.no_blocks_atom, **skw)

    def conditioning(self, batch: Batch):
        return self.diffusion_conditioning(prepare_batch(batch))

    def denoise(self, batch: Batch, x_hat, t_hat, a, ap, s, z, bias_cache=None):
        batch = prepare_batch(batch)
        return self.dit(x_hat, t_hat, a, ap, s, z, batch["ap_mask"], batch["z_mask"],
                        batch["token_id_to_chunk_sizes"], batch["atom_id_to_token_id"],
                        bias_cache=bias_cache)

    def denoise_bias_cache(self, batch: Batch, ap, z):
        batch = prepare_batch(batch)
        return self.dit.compute_bias_cache(ap, z, batch["ap_mask"], batch["z_mask"])

    def confidence(self, batch: Batch, s, z, x_pred):
        """PAE/PDE/pLDDT logits of the pose x_pred [S, A, 3] (sample 0) from
        the trunk's s and z."""
        if not self.with_confidence:
            raise ValueError("this model has no confidence head (with_confidence=False)")
        return self.confidence_module(prepare_batch(batch), s, z, x_pred)

    def distogram(self, z):
        p = self.linear_distogram(z).float()
        return p + p.transpose(-2, -3)

    def augmentation_diffuse(self, batch: Batch, generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """EDM training noising: sigma ~ exp(N(-1.2, 1.5^2)) * sigma_data over
        `num_augmentation_sample` SE(3)-augmented copies of x_gt. Every draw
        comes from `generator` on the CPU and then moves to x_gt's device, so
        card and CPU runs from one seed see the same x_hat."""
        n = self.cfg.num_augmentation_sample
        x_gt = batch["x_gt"]
        dev = x_gt.device
        t_hat = torch.exp(torch.randn(n, generator=generator) * 1.5 - 1.2) * self.cfg.sigma_data
        noise = torch.randn((n,) + tuple(x_gt.shape), generator=generator, dtype=x_gt.dtype)
        rot = uniform_random_rotation((n,), generator, "cpu")
        trans = torch.randn((n, 3), generator=generator, dtype=x_gt.dtype)
        t_hat = t_hat.to(dev)
        x = x_gt[None] + noise.to(dev) * t_hat[:, None, None]
        x_hat = apply_centre_augmentation(x, batch["x_exists"], rot.to(dev), trans.to(dev))
        return x_hat.detach(), t_hat

    def forward_noised(self, batch: Batch, x_hat, t_hat) -> Dict[str, torch.Tensor]:
        batch = prepare_batch(batch)
        a, ap, s, z = self.diffusion_conditioning(batch)
        x_denoised = self.denoise(batch, x_hat, t_hat, a, ap, s, z)
        # the mini-rollout reuses the conditioning, so the trunk runs once per step
        return {"x_denoised": x_denoised, "x_hat": x_hat, "t_hat": t_hat,
                "p_distogram": self.distogram(z), "conditioning": (a, ap, s, z)}

    def forward(self, batch: Batch, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        batch = prepare_batch(batch)
        x_hat, t_hat = self.augmentation_diffuse(batch, generator)
        return self.forward_noised(batch, x_hat, t_hat)
