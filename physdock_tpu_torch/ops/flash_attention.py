"""Flash attention with an additive bias, one (batch, head) per program:
the port of `physdock_tpu/ops/flash_attention.py::flash_sdpa`.

Call sites on the redocking path: the trunk's AtomTransformer
(q [H=4, 2048, 32], bias [4, 2048, 2048]), Pairformer's single attention
([16, 256, 32]) and MSA column attention (no bias).  A bias whose leading
axes are a suffix of q's batch axes is replayed, not copied (the
`b % lead` index map of the Pallas kernel).
"""

from __future__ import annotations

import math

from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops._flash_lib import sdpa_plain

NAME = "flash_sdpa"


def _bias_lead(bias, batch, h, s_q, s_k):
    """[lead, S_q, S_k] view of `bias` and its lead, replaying a bias
    broadcast over leading batch axes; a bias broadcast any other way is
    expanded to one block per (batch, head)."""
    full = tuple(batch) + (h,)
    lead_dims = tuple(bias.shape[:-2])
    while lead_dims and lead_dims[0] == 1:
        lead_dims = lead_dims[1:]
    if tuple(bias.shape[-2:]) == (s_q, s_k) and full[len(full) - len(lead_dims):] == lead_dims:
        lead = math.prod(lead_dims)
        return bias.reshape(lead, s_q, s_k).contiguous(), lead
    lead = math.prod(full)
    _flash_lib.BIAS_EXPANSIONS[NAME] += 1
    return bias.expand(*full, s_q, s_k).reshape(lead, s_q, s_k).contiguous(), lead


def flash_sdpa(q, k, v, bias=None):
    """q, k, v: [..., H, S, D]; bias broadcastable to [..., H, S_q, S_k]
    or None. Returns [..., H, S_q, D] in q.dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return sdpa_plain(q, k, v, bias)
    *batch, h, s_q, d = q.shape
    s_k = k.shape[-2]
    if k.shape[:-2] != q.shape[:-2] or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} do not match")
    qf = q.reshape(-1, h, s_q, d)
    kf = k.reshape(-1, h, s_k, d)
    vf = v.reshape(-1, h, s_k, d)
    b, lead = (None, 0) if bias is None else _bias_lead(bias, batch, h, s_q, s_k)
    o = _flash_lib.launch(qf, kf, vf, b, lead)
    _flash_lib.LAUNCHES[NAME] += 1
    return o.reshape(q.shape)
