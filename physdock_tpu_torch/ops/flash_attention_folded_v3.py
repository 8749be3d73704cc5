"""Stacked-head folded flash attention for long key axes: the port of
`physdock_tpu/ops/flash_attention_folded_v3.py::flash_sdpa_folded_v3`.

Call site: the sampler's atom-DiT encoder and decoder (B = 20 samples,
S = 2048 atoms, H = 4, D = 32, one [4, S, S] bias shared by all samples),
most of the sampler's work.  Under batched screening B holds the samples
of several systems, sample-major, with one [4, S, S] bias per system.  The TPU version stacked the lane-masked
heads into one matmul to spare the VPU; on Hopper the same kernel as the
other three runs on the folded strides.
"""

from __future__ import annotations

from physdock_tpu_torch.ops.flash_attention_folded import (
    _check_folded,
    _run,
    fold,
    split_view,
)

NAME = "flash_sdpa_folded_v3"


def flash_sdpa_folded_v3(q, k, v, bias, n_heads: int):
    """q, k, v: [B, S, H*D] folded; bias [H, S_q, S_k] shared across B,
    or [G, H, S_q, S_k] with row b served by block b % G. Returns [B, S_q,
    H*D] in q.dtype."""
    _check_folded(q, k, v, n_heads)
    o = _run(NAME, split_view(q, n_heads), split_view(k, n_heads),
             split_view(v, n_heads), bias)
    return fold(o)
