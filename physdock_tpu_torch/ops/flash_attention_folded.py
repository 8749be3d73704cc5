"""Head-folded flash attention, q/k/v in [B, S, H*D]: the port of
`physdock_tpu/ops/flash_attention_folded.py::flash_sdpa_folded` and
`flash_sdpa_folded_from_split`.

Call site: triangle attention (B = pair rows, H = 4, S = tokens, bias
[4, S, S] plus the -1e9 / -2e9 mask tiers).  On the TPU, folding the
heads into the 128 lanes avoided padding D = 32 to 128; here the folded
layout is a stride pattern of the same kernel, so no fold or unfold copy
is made.
"""

from __future__ import annotations

from physdock_tpu_torch.ops import _flash_lib

NAME = "flash_sdpa_folded"


def split_view(x, n_heads: int):
    """[B, S, H*D] -> [B, H, S, D] view (no copy)."""
    b, s, hd = x.shape
    return x.view(b, s, n_heads, hd // n_heads).permute(0, 2, 1, 3)


def fold(x):
    """[B, H, S, D] -> [B, S, H*D] (a view when x is folded memory)."""
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _check_folded(q, k, v, n_heads):
    if q.dim() != 3 or q.shape[-1] % n_heads:
        raise ValueError(f"q must be [B, S, H*D] with H={n_heads}, got {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")


def _run(name, q, k, v, bias):
    """[B, H, S, D] views in, [B, H, S_q, D] out; bias as
    `_flash_lib.shared_bias` takes it."""
    bias3, lead = _flash_lib.shared_bias(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    if not q.is_cuda:
        return _flash_lib.shared_plain(q, k, v, bias)
    o = _flash_lib.launch(q, k, v, bias3, lead)
    _flash_lib.LAUNCHES[name] += 1
    return o


def flash_sdpa_folded(q, k, v, bias, n_heads: int):
    """q, k, v: [B, S, H*D] folded; bias: [H, S_q, S_k] shared across B,
    or [G, H, S_q, S_k] with row b served by block b % G. Returns [B, S_q,
    H*D] in q.dtype."""
    _check_folded(q, k, v, n_heads)
    o = _run(NAME, split_view(q, n_heads), split_view(k, n_heads),
             split_view(v, n_heads), bias)
    return fold(o)


def flash_sdpa_folded_from_split(q, k, v, bias):
    """Per-head [B, H, S, D] inputs; same kernel, same result layout."""
    return _run(NAME, q, k, v, bias)
