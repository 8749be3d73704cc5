"""Transformer stacks: AtomTransformer, Triangleformer, Evoformer,
Pairformer, DiT and the AF3DiT diffusion denoiser (port of
`physdock_tpu/nn/transformers.py`).

Each stack holds its blocks in a `ModuleList` named `blocks`, where the
JAX package scans one block over stacked parameters.  While autograd
records, each block runs under activation checkpointing (`run_block`):
the counterpart of the `nn.remat` on every scanned block there.  The
backward re-runs the block's forward, attention kernels included.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from physdock_tpu_torch.nn.attentions import (
    AttentionWithPairBias,
    DiTAttention,
    MSAColumnAttention,
    MSARowAttentionWithPairBias,
    TriangleAttention,
    TriangleUpdate,
)
from physdock_tpu_torch.nn.primitives import (
    DiTTransition,
    LayerNorm,
    Linear,
    OuterProductMean,
    TimestepEmbeddings,
    Transition,
)
from physdock_tpu_torch.utils.geometry import take_rows


def _res(x, delta):
    """Residual add in the carry's (compute) dtype; sub-modules return fp32."""
    return x + delta.to(x.dtype)


def run_block(blk, *args):
    """One block of a stack: checkpointed when grad mode is on (only its
    inputs are kept for the backward), a plain call otherwise, so
    redocking under `no_grad` does not change. `set_remat(model, False)`
    keeps every activation instead (no recompute: fewer launches, more
    memory; the same numbers, as every kernel is deterministic)."""
    if torch.is_grad_enabled() and getattr(blk, "remat", True):
        # the blocks draw no random numbers: no RNG state to stash
        return checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False)
    return blk(*args)


def set_remat(model: nn.Module, on: bool) -> None:
    """Checkpoint (`on`) or keep the activations of every block of every
    stack in `model` under grad."""
    for m in model.modules():
        if isinstance(m, _Stack):
            for blk in m.blocks:
                blk.remat = on


class _Stack(nn.Module):
    def __init__(self, make_block, no_blocks: int):
        super().__init__()
        self.blocks = nn.ModuleList([make_block() for _ in range(no_blocks)])


# ------------------------------- Atom stack --------------------------------


class AtomBlock(nn.Module):
    """AttentionWithPairBias + Transition over the full atom pair grid."""

    def __init__(self, c_a, c_ap, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.attention = AttentionWithPairBias(c_a, c_ap, inf, eps, dtype, generator)
        self.transition = Transition(c_a, eps=eps, dtype=dtype, generator=generator)

    def forward(self, a, ap, ap_mask):
        a = _res(a, self.attention(a, ap, ap_mask))
        return _res(a, self.transition(a))


class AtomTransformer(_Stack):
    def __init__(self, c_a, c_ap, no_blocks, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__(lambda: AtomBlock(c_a, c_ap, inf, eps, dtype, generator),
                         no_blocks)
        self.dtype = dtype

    def forward(self, a, ap, ap_mask):
        a = a.to(self.dtype)
        for blk in self.blocks:
            a = run_block(blk, a, ap, ap_mask)
        return a


# ----------------------------- Triangle stack ------------------------------


def _triangle_set(mod, c_z, inf, eps, dtype, generator):
    kw = dict(eps=eps, dtype=dtype, generator=generator)
    akw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
    mod.triangle_row_update = TriangleUpdate(c_z, **kw)
    mod.triangle_col_update = TriangleUpdate(c_z, transpose=True, **kw)
    mod.triangle_row_attention = TriangleAttention(c_z, **akw)
    mod.triangle_col_attention = TriangleAttention(c_z, transpose=True, **akw)


def _apply_triangle_set(mod, z, z_mask, pad_mask=None):
    z = _res(z, mod.triangle_row_update(z, z_mask))
    z = _res(z, mod.triangle_col_update(z, z_mask))
    z = _res(z, mod.triangle_row_attention(z, z_mask, pad_mask))
    z = _res(z, mod.triangle_col_attention(z, z_mask, pad_mask))
    return z


class TriangleBlock(nn.Module):
    """tri-mult row/col + tri-attn row/col + transition."""

    def __init__(self, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        _triangle_set(self, c_z, inf, eps, dtype, generator)
        self.pair_transition = Transition(c_z, eps=eps, dtype=dtype, generator=generator)

    def forward(self, z, z_mask, pad_mask=None):
        z = _apply_triangle_set(self, z, z_mask, pad_mask)
        return _res(z, self.pair_transition(z))


class Triangleformer(_Stack):
    def __init__(self, c_z, no_blocks, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__(lambda: TriangleBlock(c_z, inf, eps, dtype, generator),
                         no_blocks)
        self.dtype = dtype

    def forward(self, z, z_mask, pad_mask=None):
        z = z.to(self.dtype)
        for blk in self.blocks:
            z = run_block(blk, z, z_mask, pad_mask)
        return z


# ----------------------------- Evoformer stack -----------------------------


class EvoformerBlock(nn.Module):
    """MSA row/col attention + transition + OPM + triangle set."""

    def __init__(self, c_m, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        akw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
        kw = dict(eps=eps, dtype=dtype, generator=generator)
        self.msa_row_attention = MSARowAttentionWithPairBias(c_m, c_z, **akw)
        self.msa_col_attention = MSAColumnAttention(c_m, **akw)
        self.msa_transition = Transition(c_m, **kw)
        self.opm = OuterProductMean(c_m, c_z, **kw)
        _triangle_set(self, c_z, inf, eps, dtype, generator)
        self.pair_transition = Transition(c_z, **kw)

    def forward(self, m, z, z_mask):
        m = _res(m, self.msa_row_attention(m, z, z_mask))
        m = _res(m, self.msa_col_attention(m))
        m = _res(m, self.msa_transition(m))
        z = _res(z, self.opm(m))
        z = _apply_triangle_set(self, z, z_mask)
        z = _res(z, self.pair_transition(z))
        return m, z


class Evoformer(_Stack):
    def __init__(self, c_m, c_z, no_blocks=4, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__(
            lambda: EvoformerBlock(c_m, c_z, inf, eps, dtype, generator), no_blocks)
        self.dtype = dtype

    def forward(self, m, z, z_mask):
        m, z = m.to(self.dtype), z.to(self.dtype)
        for blk in self.blocks:
            m, z = run_block(blk, m, z, z_mask)
        return m, z


# ----------------------------- Pairformer stack ----------------------------


class PairFormerBlock(nn.Module):
    """Triangle set + single attention with pair bias."""

    def __init__(self, c_s, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(eps=eps, dtype=dtype, generator=generator)
        _triangle_set(self, c_z, inf, eps, dtype, generator)
        self.pair_transition = Transition(c_z, **kw)
        self.attention = AttentionWithPairBias(c_s, c_z, inf, eps, dtype, generator)
        self.transition = Transition(c_s, **kw)

    def forward(self, s, z, z_mask):
        z = _apply_triangle_set(self, z, z_mask)
        z = _res(z, self.pair_transition(z))
        s = _res(s, self.attention(s, z, z_mask))
        s = _res(s, self.transition(s))
        return s, z


class Pairformer(_Stack):
    def __init__(self, c_s, c_z, no_blocks=24, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__(
            lambda: PairFormerBlock(c_s, c_z, inf, eps, dtype, generator), no_blocks)
        self.dtype = dtype

    def forward(self, s, z, z_mask):
        s, z = s.to(self.dtype), z.to(self.dtype)
        for blk in self.blocks:
            s, z = run_block(blk, s, z, z_mask)
        return s, z


# -------------------------------- DiT stack --------------------------------


class DiTBlock(nn.Module):
    """AdaLN-Zero DiT block; the attention's pair bias comes precomputed."""

    def __init__(self, c_s, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.attention = DiTAttention(c_s, c_z, inf, eps, dtype, generator)
        self.transition = DiTTransition(c_s, eps=eps, dtype=dtype, generator=generator)

    def forward(self, bs, t, bias):
        bs = _res(bs, self.attention(bs, t, bias))
        return _res(bs, self.transition(bs, t))


class DiT(_Stack):
    def __init__(self, c_s, c_z, no_blocks=12, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__(
            lambda: DiTBlock(c_s, c_z, inf, eps, dtype, generator), no_blocks)
        self.dtype = dtype

    def compute_bias(self, z, z_mask):
        """Per-block pair biases [no_blocks, H, S, S] (cached once per
        round); [no_blocks, Bsys, H, S, S] for z [Bsys, S, S, c_z]."""
        return torch.stack([run_block(blk.attention.compute_bias, z, z_mask)
                            for blk in self.blocks])

    def forward(self, bs, t, cached_bias):
        bs = bs.to(self.dtype)
        for blk, bias in zip(self.blocks, cached_bias):
            bs = run_block(blk, bs, t, bias)
        return bs


# --------------------------------- AF3DiT ----------------------------------


def segment_mean_pool(x, token_id_to_chunk_sizes, eps: float = 1e-3):
    """Mean-pool atom features into tokens via the cumsum-diff trick.
    x: [..., A, C]; sizes: [T] int (0 for padded tokens -> zeros), or
    [Bsys, T] for x [..., Bsys, A, C], one system's sizes each."""
    x_cumsum = torch.cumsum(x.float(), dim=-2)
    inds = torch.cumsum(token_id_to_chunk_sizes, dim=-1) - 1
    value = take_rows(x_cumsum, inds.clamp_min(0))
    x_tok = torch.cat([value[..., :1, :], torch.diff(value, dim=-2)], dim=-2)
    sizes = token_id_to_chunk_sizes.to(x.dtype)
    return x_tok / (sizes[..., None] + eps)


class AF3DiT(nn.Module):
    """EDM-preconditioned atom -> token -> atom DiT denoiser.

    `compute_bias_cache` precomputes the per-block attention biases from
    (ap, z) once per round; every diffusion step reuses them.

    With a system axis (several ligand-systems of one shape, as
    `jax.vmap` gives the JAX denoiser), every input leads with it: x_hat
    [Bsys, N, A, 3], t_hat [Bsys, N], a [Bsys, A, c_a], the biases [...,
    Bsys, H, S, S], the index maps [Bsys, ...].  The DiT runs on samples
    laid out sample-major ([N, Bsys, ...]), so sample n of system b is
    row n * Bsys + b and the attention kernels serve each system's bias
    to its own samples without a copy (lead Bsys * H)."""

    def __init__(self, c_a, c_ap, c_s, c_z, no_blocks_atom, no_blocks_dit,
                 sigma_data=16.0, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.sigma_data = sigma_data
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        akw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
        self.linear_x = Linear(3, c_a, **kw)
        self.linear_downscale = Linear(c_a, c_s, **kw)
        self.linear_upscale = Linear(c_s, c_a, **kw)
        self.time_embedder = TimestepEmbeddings(**kw)
        self.atom_dit_encoder = DiT(c_a, c_ap, no_blocks_atom, **akw)
        self.token_dit = DiT(c_s, c_z, no_blocks_dit, **akw)
        self.atom_dit_decoder = DiT(c_a, c_ap, no_blocks_atom, **akw)
        self.norm_r = LayerNorm(c_a, eps=eps, dtype=dtype)
        self.linear_r = Linear(c_a, 3, bias=False, **kw)

    def compute_bias_cache(self, ap, z, ap_mask, z_mask) -> Dict[str, torch.Tensor]:
        return {
            "atom_enc": self.atom_dit_encoder.compute_bias(ap, ap_mask),
            "token": self.token_dit.compute_bias(z, z_mask),
            "atom_dec": self.atom_dit_decoder.compute_bias(ap, ap_mask),
        }

    def forward(self, x_hat, t_hat, a, ap, s, z, ap_mask, z_mask,
                token_id_to_chunk_sizes, atom_id_to_token_id, bias_cache=None):
        if bias_cache is None:
            bias_cache = self.compute_bias_cache(ap, z, ap_mask, z_mask)
        systems = atom_id_to_token_id.dim() == 2
        if systems:
            x_hat, t_hat = x_hat.transpose(0, 1), t_hat.transpose(0, 1)
        sd = self.sigma_data
        c_in = 1.0 / torch.sqrt(t_hat[..., None, None] ** 2 + sd**2)
        c_noise = torch.log(t_hat / sd) / 4.0
        ba = self.linear_x((x_hat * c_in).to(self.dtype)) + a[None].to(self.dtype)
        t = self.time_embedder(t_hat * c_noise)

        ba = self.atom_dit_encoder(ba, t, bias_cache["atom_enc"])
        pooled = segment_mean_pool(F.silu(self.linear_downscale(ba)), token_id_to_chunk_sizes)
        bs = pooled + s[None].to(pooled.dtype)
        bs = self.token_dit(bs, t, bias_cache["token"])
        ba = ba + take_rows(self.linear_upscale(bs), atom_id_to_token_id).float()
        ba = self.atom_dit_decoder(ba, t, bias_cache["atom_dec"])

        r = self.linear_r(self.norm_r(ba)).float()
        c_skip = (sd**2 / (sd**2 + t_hat**2))[..., None, None]
        c_out = (sd * t_hat / torch.sqrt(sd**2 + t_hat**2))[..., None, None]
        x = c_skip * x_hat + c_out * r
        return x.transpose(0, 1) if systems else x
