"""Flash attention over a sample batch sharing one [H, S, S] bias: the
port of `physdock_tpu/ops/flash_attention_grouped.py::flash_sdpa_grouped`.

Call sites: the token DiT (B = samples, H = 16, S = tokens) and MSA row
attention (B = MSA rows, H = 8).  The TPU kernel looped G samples per
program to read each bias tile once; here consecutive blocks of the grid
are the samples of one (head, query tile), so the bias tile is re-read
from L2 rather than from device memory.  Under batched screening the
token DiT's batch holds the samples of several systems, sample-major,
and the bias is one [H, S, S] block per system (`_flash_lib.shared_bias`).
"""

from __future__ import annotations

from physdock_tpu_torch.ops import _flash_lib

NAME = "flash_sdpa_grouped"


def flash_sdpa_grouped(q, k, v, bias):
    """q, k, v: [B, H, S, D]; bias: [H, S_q, S_k] shared across B, or
    [G, H, S_q, S_k] with row b served by block b % G. Returns [B, H, S_q,
    D] in q.dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, s_q, _ = q.shape
    bias3, lead = _flash_lib.shared_bias(bias, b, h, s_q, k.shape[-2])
    if not q.is_cuda:
        return _flash_lib.shared_plain(q, k, v, bias)
    o = _flash_lib.launch(q, k, v, bias3, lead)
    _flash_lib.LAUNCHES[NAME] += 1
    return o
