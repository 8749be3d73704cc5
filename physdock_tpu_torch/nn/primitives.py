"""Core NN primitives (port of `physdock_tpu/nn/primitives.py`).

Parameters live in fp32; matmuls run in the module's compute `dtype`
(fp32 or bf16); normalization statistics are always fp32.  Module and
parameter names are the JAX package's, so `model/weights.py` maps a flat
JAX `.npz` onto `state_dict()` by renaming alone; `Linear.weight` is
stored [out, in] as PyTorch does (the JAX kernel is [in, out]).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from physdock_tpu_torch.parallel.tp import shard_rows

TRUNC_STD = 0.87962566103423978  # std of the standard truncated normal on [-2, 2]


def _init_linear(weight, bias, init: str, generator: Optional[torch.Generator]):
    """The AF-style initializer zoo (primitives/linear.py of the reference),
    for runs without a checkpoint."""
    out_f, in_f = weight.shape
    with torch.no_grad():
        if init in ("gating", "final"):
            weight.zero_()
        elif init == "glorot":
            a = math.sqrt(6.0 / (in_f + out_f))
            weight.uniform_(-a, a, generator=generator)
        else:
            scale = 2.0 if init == "relu" else 1.0
            std = math.sqrt(scale / max(1, in_f))
            if init == "normal":
                weight.normal_(0.0, std, generator=generator)
            else:
                nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
                weight.mul_(std / TRUNC_STD)
        if bias is not None:
            bias.fill_({"gating": 1.0, "bias_fill_-2": -2.0}.get(init, 0.0))


class Linear(nn.Module):
    """Dense layer: y = x @ W^T + b in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "default", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        _init_linear(self.weight, self.bias, init, generator)

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RMSNorm(nn.Module):
    """LLaMA-style RMSNorm; stats in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim)) if use_bias else None

    def forward(self, x):
        x32 = x.float()
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class AdaLayerNormZero(nn.Module):
    """AdaLN-Zero: t(256) -> (shift, scale, gate); affine-free LayerNorm."""

    def __init__(self, dim: int, t_dim: int = 256, eps: float = 1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.linear = Linear(t_dim, 3 * dim, dtype=dtype, generator=generator)
        self.norm = LayerNorm(dim, eps=eps, use_scale=False, use_bias=False, dtype=dtype)

    def forward(self, x, t):
        mod = self.linear(F.silu(t[..., None, :]))
        shift, scale, gate = torch.chunk(mod, 3, dim=-1)
        x = self.norm(x)
        return x * (1 + scale) + shift, gate


class FeedForward(nn.Module):
    """LLaMA SwiGLU MLP; hidden = 2/3 * 4d rounded up to 128."""

    def __init__(self, dim: int, hidden_dim: Optional[int] = None, multiple_of: int = 128,
                 dtype=torch.float32, generator=None):
        super().__init__()
        hidden = int(2 * (hidden_dim if hidden_dim is not None else 4 * dim) / 3)
        hidden = multiple_of * ((hidden + multiple_of - 1) // multiple_of)
        self.w1 = Linear(dim, hidden, bias=False, dtype=dtype, generator=generator)
        self.w3 = Linear(dim, hidden, bias=False, dtype=dtype, generator=generator)
        self.w2 = Linear(hidden, dim, bias=False, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Transition(nn.Module):
    """RMSNorm + SwiGLU transition."""

    def __init__(self, dim: int, eps: float = 1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.ffn_norm = RMSNorm(dim, eps=eps, dtype=dtype)
        self.feed_forward = FeedForward(dim, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.feed_forward(self.ffn_norm(x))


class DiTTransition(nn.Module):
    """AdaLN-Zero-modulated transition."""

    def __init__(self, dim: int, eps: float = 1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        self.ffn_norm = AdaLayerNormZero(dim, eps=eps, dtype=dtype, generator=generator)
        self.feed_forward = FeedForward(dim, dtype=dtype, generator=generator)

    def forward(self, x, t):
        x_norm, gate = self.ffn_norm(x, t)
        return self.feed_forward(x_norm) * gate


class OuterProductMean(nn.Module):
    """MSA -> pair outer-product update: an outer-product *sum* over MSA
    rows, then a zero-init projection and RMSNorm (as in the reference).
    Under tp, this rank's rows i of the pair update from the replicated
    MSA: no collective."""

    def __init__(self, c_m: int, c_z: int, c_hidden: int = 32, eps: float = 1e-8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.c_hidden = c_hidden
        self.norm_in = RMSNorm(c_m, eps=eps, dtype=dtype)
        self.linear_q = Linear(c_m, c_hidden, dtype=dtype, generator=generator)
        self.linear_k = Linear(c_m, c_hidden, dtype=dtype, generator=generator)
        self.linear_o = Linear(c_hidden * c_hidden, c_z, init="final", dtype=dtype,
                               generator=generator)
        self.norm_out = RMSNorm(c_z, eps=eps, dtype=dtype)

    def forward(self, m):
        m_norm = self.norm_in(m)
        q = self.linear_q(m_norm)
        k = self.linear_k(m_norm)
        outer = torch.einsum("...bic,...bjd->...ijcd", shard_rows(q, -2), k)
        outer = outer.reshape(outer.shape[:-2] + (self.c_hidden * self.c_hidden,))
        return self.norm_out(self.linear_o(outer))


def sinusoidal_timestep_embedding(timesteps, embedding_dim: int = 256,
                                  max_period: float = 10000.0):
    """Diffusers-lineage sinusoidal embedding with flip_sin_to_cos=True and
    shift 0. timesteps: [...] -> [..., embedding_dim]."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / half
    emb = timesteps.float()[..., None] * torch.exp(exponent)
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return torch.cat([emb[..., half:], emb[..., :half]], dim=-1)


class TimestepEmbeddings(nn.Module):
    """Sinusoidal projection + 2-layer MLP."""

    def __init__(self, embedding_dim: int = 256, dtype=torch.float32, generator=None):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dtype = dtype
        self.linear_1 = Linear(embedding_dim, embedding_dim, dtype=dtype, generator=generator)
        self.linear_2 = Linear(embedding_dim, embedding_dim, dtype=dtype, generator=generator)

    def forward(self, timesteps):
        proj = sinusoidal_timestep_embedding(timesteps, self.embedding_dim)
        return self.linear_2(F.silu(self.linear_1(proj.to(self.dtype))))
