"""The PhysDock model for inference: conditioning trunk + AF3DiT denoiser
(port of `physdock_tpu/model/physdock.py`, inference entry points).

  * `conditioning(batch)` -- (a, ap, s, z), once per system and round
  * `denoise_bias_cache(batch, ap, z)` -- per-block DiT biases, once per round
  * `denoise(batch, x_hat, t_hat, a, ap, s, z, bias_cache)` -- one denoiser call
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from physdock_tpu_torch.config import ModelConfig
from physdock_tpu_torch.model.compact import expand_batch
from physdock_tpu_torch.nn.conditioning import DiffusionConditioning
from physdock_tpu_torch.nn.primitives import Linear
from physdock_tpu_torch.nn.transformers import AF3DiT

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
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, generator=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        skw = dict(inf=c.inf, eps=c.eps, dtype=dtype, generator=generator)
        self.diffusion_conditioning = DiffusionConditioning(
            c.ref_dim, c.target_dim, c.msa_dim, c.c_a, c.c_ap, c.c_s, c.c_m, c.c_z,
            c.no_blocks_atom, c.no_blocks_evoformer, c.no_blocks_pairformer,
            c.no_blocks_template, c.num_recycles, **skw)
        self.dit = AF3DiT(c.c_a, c.c_ap, c.c_s, c.c_z, c.no_blocks_atom, c.no_blocks_dit,
                          c.sigma_data, **skw)
        # the distogram head is training-only; kept so checkpoints load whole
        self.linear_distogram = Linear(c.c_z, c.no_distogram_bins, init="final", dtype=dtype,
                                       generator=generator)

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
