"""Flash attention with softmax stats, and its backward, for a bias shared
over the batch: the port of `physdock_tpu/ops/flash_attention_bwd.py`
(`flash_fwd_lse` and `flash_bwd`).

Call sites, under training only (`ops/attention.py::_FoldedDiff`): the
atom-DiT encoder and decoder (B = diffusion samples, H = 4, S = atoms,
D = 32) and triangle attention (B = pair rows, H = 4, S = tokens), i.e.
every shared-bias attention with H*D = 128.

    delta_i = sum_d dO_id O_id
    P_ij    = exp(q_i k_j / sqrt(d) + b_ij - m_i) / l_i
    dV_j    = sum_i P_ij dO_i
    dS_ij   = P_ij (dO_i . v_j - delta_i)
    dQ_i    = sum_j dS_ij k_j / sqrt(d)
    dK_j    = sum_i dS_ij q_i / sqrt(d)
    dB_ij   = sum_batch dS_ij

The row max `m` and normalizer `l` stay separate: with -1e9 mask biases
`logits - m` cancels exactly, where a fused lse = m + log(l) loses log(l)
below ulp(1e9) and makes fully masked rows' gradients 10-60x too large.
The forward is `csrc/flash_fwd.cu` with its stats outputs, the backward
`csrc/flash_bwd.cu`; a CPU tensor takes the plain version.
"""

from __future__ import annotations

import math

import torch

from physdock_tpu_torch.ops import _flash_lib

NAME_FWD = "flash_fwd_lse"
NAME_BWD = "flash_bwd"


def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} "
                         "must be [B, H, S, D]")
    b, h, s_q, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if tuple(bias.shape) != (h, s_q, k.shape[2]):
        raise ValueError(f"bias {tuple(bias.shape)} != {(h, s_q, k.shape[2])}")


def _logits(q, k, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale + bias.float()


def flash_fwd_lse_plain(q, k, v, bias):
    """Plain version of `flash_fwd_lse`: fp32 logits, row max and sum."""
    logits = _logits(q, k, bias)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / l[..., None]
    return o.to(q.dtype), m, l


def flash_fwd_lse(q, k, v, bias):
    """q, k, v: [B, H, S, D]; bias [H, S_q, S_k] shared across B. Returns
    (o [B, H, S_q, D] in q's dtype, m, l fp32 [B, H, S_q])."""
    _check(q, k, v, bias)
    if not q.is_cuda:
        return flash_fwd_lse_plain(q, k, v, bias)
    o, m, l = _flash_lib.launch(q, k, v, bias.contiguous(), q.shape[1], stats=True)
    _flash_lib.LAUNCHES[NAME_FWD] += 1
    return o, m, l


def flash_bwd_plain(q, k, v, bias, o, m, l, do):
    """Plain version of `flash_bwd`, the formulas above in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    do32 = do.float()
    delta = torch.sum(do32 * o.float(), dim=-1)
    p = torch.exp(_logits(q, k, bias) - m[..., None]) / l[..., None]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=0)


def flash_bwd(q, k, v, bias, o, m, l, do):
    """Backward of shared-bias attention. q/k/v/o/do: [B, H, S, D]; bias
    [H, S_q, S_k]; m/l fp32 [B, H, S_q] from `flash_fwd_lse`. Returns
    (dq, dk, dv) in q's dtype and dbias fp32 [H, S_q, S_k], summed over B."""
    _check(q, k, v, bias)
    if not q.is_cuda:
        return flash_bwd_plain(q, k, v, bias, o, m, l, do)
    # delta outside the kernel, as the JAX package computes it outside Pallas
    delta = torch.sum(do.float() * o.float(), dim=-1)
    out = _flash_lib.launch_bwd(q, k, v, bias.contiguous(), m, l, delta, do)
    _flash_lib.LAUNCHES[NAME_BWD] += 1
    return out
