"""Attention-variant modules (port of `physdock_tpu/nn/attentions.py`).

Head dim is fixed at 32 with heads = channels / 32; outputs are gated by a
linear (sigmoid-free) gate except where noted and cast back to fp32.  Every
SDPA call goes through `ops.attention.dot_product_attention`, which routes
it to one of the four Hopper kernel wrappers on CUDA.

Under pair-row tensor parallelism (`parallel/tp.py`) z arrives with this
rank's S/tp rows and the masks whole; each module's docstring says which
collective it makes (the pair-bias attentions none of their own: the
dispatcher runs the rank's query rows and gathers the output).
"""

from __future__ import annotations

import torch
from torch import nn

from physdock_tpu_torch.nn.primitives import (
    AdaLayerNormZero,
    LayerNorm,
    Linear,
    RMSNorm,
)
from physdock_tpu_torch.ops.attention import dot_product_attention
from physdock_tpu_torch.parallel.tp import gather_rows, rows_like, shard_rows, tp_active
from physdock_tpu_torch.utils.geometry import gen_attn_mask

C_HIDDEN = 32  # per-head dim


def _split_heads(x, h):
    # [..., S, H*D] -> [..., H, S, D] (a view)
    *lead, s, hd = x.shape
    return x.view(*lead, s, h, hd // h).transpose(-2, -3)


def _merge_heads(x):
    # [..., H, S, D] -> [..., S, H*D]
    y = x.transpose(-2, -3)
    *lead, s, h, d = y.shape
    return y.reshape(*lead, s, h * d)


def _qkvg(c, dtype, gen):
    return (
        Linear(c, c, bias=False, dtype=dtype, generator=gen),
        Linear(c, c, bias=False, dtype=dtype, generator=gen),
        Linear(c, c, bias=False, dtype=dtype, generator=gen),
        Linear(c, c, dtype=dtype, generator=gen),
    )


class AttentionWithPairBias(nn.Module):
    """Single-rep attention with pair bias. s: [S, c_s]; z: [S, S, c_z];
    z_mask: [S, S]. Under tp z holds the rank's rows, and so does the bias."""

    def __init__(self, c_s, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.h = c_s // C_HIDDEN
        self.inf = inf
        self.norm_s = RMSNorm(c_s, eps=eps, dtype=dtype)
        self.norm_z = RMSNorm(c_z, eps=eps, dtype=dtype)
        self.linear_q, self.linear_k, self.linear_v, self.linear_g = _qkvg(c_s, dtype, generator)
        self.linear_z = Linear(c_z, self.h, bias=False, dtype=dtype, generator=generator)
        self.linear_o = Linear(c_s, c_s, dtype=dtype, generator=generator)

    def forward(self, s, z, z_mask):
        h = self.h
        s_norm = self.norm_s(s)
        z_norm = self.norm_z(z)
        q, k, v = (_split_heads(f(s_norm), h) for f in (self.linear_q, self.linear_k, self.linear_v))
        g = self.linear_g(s_norm)
        bias = torch.movedim(self.linear_z(z_norm), -1, -3)
        bias = bias + gen_attn_mask(rows_like(z_mask.float(), z.shape[-3]), -self.inf)[None]
        o = _merge_heads(dot_product_attention(q, k, v, bias))
        return (self.linear_o(o) * g).float()


class MSARowAttentionWithPairBias(nn.Module):
    """Row-wise MSA attention with pair bias. m: [B, S, c_m]; z: [S, S, c_z]
    (under tp the rank's rows, and so the bias's)."""

    def __init__(self, c_m, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.h = c_m // C_HIDDEN
        self.inf = inf
        self.norm_m = RMSNorm(c_m, eps=eps, dtype=dtype)
        self.norm_z = RMSNorm(c_z, eps=eps, dtype=dtype)
        self.linear_q, self.linear_k, self.linear_v, self.linear_g = _qkvg(c_m, dtype, generator)
        self.linear_z = Linear(c_z, self.h, bias=False, dtype=dtype, generator=generator)
        self.linear_o = Linear(c_m, c_m, dtype=dtype, generator=generator)

    def forward(self, m, z, z_mask):
        h = self.h
        m_norm = self.norm_m(m)
        z_norm = self.norm_z(z)
        q, k, v = (_split_heads(f(m_norm), h) for f in (self.linear_q, self.linear_k, self.linear_v))
        g = self.linear_g(m_norm)
        # 3-D [h, S, S] bias shared by all MSA rows -> the grouped kernel
        bias = torch.movedim(self.linear_z(z_norm), -1, -3)
        bias = bias + gen_attn_mask(rows_like(z_mask.float(), z.shape[-3]), -self.inf)[..., None, :, :]
        o = _merge_heads(dot_product_attention(q, k, v, bias))
        return (self.linear_o(o) * g).float()


class MSAColumnAttention(nn.Module):
    """Column-wise MSA attention, no bias."""

    def __init__(self, c_m, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.h = c_m // C_HIDDEN
        self.norm_m = RMSNorm(c_m, eps=eps, dtype=dtype)
        self.linear_q, self.linear_k, self.linear_v, self.linear_g = _qkvg(c_m, dtype, generator)
        self.linear_o = Linear(c_m, c_m, dtype=dtype, generator=generator)

    def forward(self, m):
        m = m.transpose(-2, -3)  # attend along the sequence axis per column
        h = self.h
        m_norm = self.norm_m(m)
        q, k, v = (_split_heads(f(m_norm), h) for f in (self.linear_q, self.linear_k, self.linear_v))
        g = self.linear_g(m_norm)
        o = _merge_heads(dot_product_attention(q, k, v, None))
        o = self.linear_o(o) * g
        return o.transpose(-2, -3).float()


class TriangleUpdate(nn.Module):
    """Combined incoming/outgoing triangular multiplicative update; the
    incoming variant (transpose=True) folds the transpose into the einsum
    index order instead of transposing z. Under tp (z the rank's rows i)
    the outgoing update gathers the b projection (all k rows), the
    incoming one both projections (all j rows)."""

    def __init__(self, c_z, transpose=False, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.transpose = transpose
        self.norm_in = RMSNorm(c_z, eps=eps, dtype=dtype)
        kw = dict(dtype=dtype, generator=generator)
        self.linear_qx = Linear(c_z, C_HIDDEN, **kw)
        self.linear_q = Linear(c_z, C_HIDDEN, **kw)
        self.linear_kx = Linear(c_z, C_HIDDEN, **kw)
        self.linear_k = Linear(c_z, C_HIDDEN, **kw)
        self.linear_g = Linear(c_z, c_z, init="gating", **kw)
        self.norm_out = RMSNorm(C_HIDDEN, eps=eps, dtype=dtype)
        self.linear_z = Linear(C_HIDDEN, c_z, init="final", **kw)

    def forward(self, z, z_mask):
        mask = rows_like(z_mask, z.shape[-3])[..., None].to(z.dtype)
        z = self.norm_in(z)
        q = self.linear_qx(z) * torch.sigmoid(self.linear_q(z)) * mask
        k = self.linear_kx(z) * torch.sigmoid(self.linear_k(z)) * mask
        g = torch.sigmoid(self.linear_g(z))
        if self.transpose:
            # k of every row j, at this rank's columns i
            k = shard_rows(gather_rows(k), -2)
            prod = torch.einsum("...jic,...jkc->...ikc", k, gather_rows(q))
        else:
            prod = torch.einsum("...ijc,...kjc->...ikc", q, gather_rows(k))
        prod = self.norm_out(prod)
        return (self.linear_z(prod) * g).float()


class TriangleAttention(nn.Module):
    """Triangle attention around the starting (transpose=False) or ending
    node.  `pad_mask` marks padded tokens with a second mask tier at
    -2 * inf, so pad keys vanish relative to other masked keys in rows
    whose `z_mask` is fully masked.

    Under tp (z the rank's rows i): around the starting node each row i
    attends within itself, so only the bias, which every row shares, is
    gathered [H, S, S]. Around the ending node the rank's rows are query
    columns of z's transpose: the normalized z is gathered, every row's
    keys and values come from it, and the queries and the bias rows from
    the rank's own rows (S_q = S/tp against S_k = S)."""

    def __init__(self, c_z, transpose=False, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.transpose = transpose
        self.h = c_z // C_HIDDEN
        self.inf = inf
        self.norm = RMSNorm(c_z, eps=eps, dtype=dtype)
        self.linear_q, self.linear_k, self.linear_v, self.linear_g = _qkvg(c_z, dtype, generator)
        self.linear_z = Linear(c_z, self.h, bias=False, dtype=dtype, generator=generator)
        self.linear_o = Linear(c_z, c_z, dtype=dtype, generator=generator)

    def forward(self, z, z_mask, pad_mask=None):
        if self.transpose:
            z_mask = z_mask.transpose(-1, -2)
            if pad_mask is not None:
                pad_mask = pad_mask.transpose(-1, -2)
        h = self.h
        if self.transpose and tp_active():
            z_norm = self.norm(z)
            z_q = z_norm.transpose(-2, -3)  # [S, S/tp, C]: the rank's query columns
            z_all = gather_rows(z_norm).transpose(-2, -3)
            q = _split_heads(self.linear_q(z_q), h)
            k, v = (_split_heads(f(z_all), h) for f in (self.linear_k, self.linear_v))
            g = self.linear_g(z_q)
            bias = torch.movedim(self.linear_z(shard_rows(z_all)), -1, -3)
        else:
            if self.transpose:
                z = z.transpose(-2, -3)
            z_norm = self.norm(z)
            q, k, v = (_split_heads(f(z_norm), h)
                       for f in (self.linear_q, self.linear_k, self.linear_v))
            g = self.linear_g(z_norm)
            # bias stays 3-D [h, S, S], shared by every row -> the folded kernel
            bias = gather_rows(torch.movedim(self.linear_z(z_norm), -1, -3), -2)
        rows = bias.shape[-2]
        bias = bias + gen_attn_mask(rows_like(z_mask.float(), rows), -self.inf)[..., None, :, :]
        if pad_mask is not None:
            bias = bias + gen_attn_mask(rows_like(pad_mask.float(), rows),
                                        -2.0 * self.inf)[..., None, :, :]
        o = _merge_heads(dot_product_attention(q, k, v, bias))
        o = self.linear_o(o) * g
        if self.transpose:
            o = o.transpose(-2, -3)
        return o.float()


class DiTAttention(nn.Module):
    """AdaLN-Zero-modulated attention with pair bias and q/k RMSNorm.
    bs: [B, S, c_s] (B = diffusion samples); t: [B, 256]; bias [H, S, S].
    With a system axis: bs [N, Bsys, S, c_s], t [N, Bsys, 256], bias
    [Bsys, H, S, S], each system's bias shared by its N samples.

    The pair bias depends only on the conditioning, so `compute_bias` runs
    once per round and every diffusion step reuses it."""

    def __init__(self, c_s, c_z, inf=1e9, eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.h = c_s // C_HIDDEN
        self.inf = inf
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.norm_s = AdaLayerNormZero(c_s, eps=eps, **kw)
        self.norm_z = LayerNorm(c_z, dtype=dtype)
        self.linear_q = Linear(c_s, c_s, bias=False, **kw)
        self.linear_k = Linear(c_s, c_s, bias=False, **kw)
        self.linear_v = Linear(c_s, c_s, bias=False, **kw)
        self.linear_z = Linear(c_z, self.h, bias=False, **kw)
        self.norm_q = RMSNorm(C_HIDDEN, eps=eps, dtype=dtype)
        self.norm_k = RMSNorm(C_HIDDEN, eps=eps, dtype=dtype)
        self.linear_o = Linear(c_s, c_s, **kw)

    def compute_bias(self, z, z_mask):
        """[..., H, S, S] pair bias incl. the additive mask, stored in the
        compute dtype (bf16 halves the per-step read of the cached bias)."""
        bias = torch.movedim(self.linear_z(self.norm_z(z)), -1, -3)
        mask = gen_attn_mask(z_mask.float(), -self.inf)[..., None, :, :]
        return (bias.float() + mask).to(self.dtype).contiguous()

    def forward(self, bs, t, bias):
        h = self.h
        bs_norm, gate = self.norm_s(bs, t)
        q = self.norm_q(_split_heads(self.linear_q(bs_norm), h))
        k = self.norm_k(_split_heads(self.linear_k(bs_norm), h))
        v = _split_heads(self.linear_v(bs_norm), h)
        o = _merge_heads(dot_product_attention(q, k, v, bias))
        o = self.linear_o(o).float()
        return o * gate.float()
