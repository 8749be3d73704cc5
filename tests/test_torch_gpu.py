"""Tests of the port that need a CUDA card (marker `gpu`; each skips inside
itself when there is none). This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Each wrapper launches the CUDA kernel on ragged shapes (neither axis a
multiple of the 64-row tile), with fully masked rows and the -1e9 / -2e9
tiers, and is held against its plain version on the same card tensors:
fp32 max abs error <= 1e-4 with TF32 off, bf16 <= 2e-2.
"""

import numpy as np
import pytest
import torch

from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops.attention import dot_product_attention
from physdock_tpu_torch.ops.flash_attention import flash_sdpa
from physdock_tpu_torch.ops.flash_attention_folded import (
    flash_sdpa_folded,
    fold,
    split_view,
)
from physdock_tpu_torch.ops.flash_attention_folded_v3 import flash_sdpa_folded_v3
from physdock_tpu_torch.ops.flash_attention_grouped import flash_sdpa_grouped

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(seed, q_shape, kv_shape, h, s_q, s_k, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape))
    bias = rng.normal(size=(h, s_q, s_k)).astype(np.float32)
    mask = rng.random((s_q, s_k)) < 0.2
    mask[:5] = True  # fully masked rows
    pad = np.zeros((s_q, s_k), bool)
    pad[:, s_k - s_k // 8:] = True
    bias = bias + np.where(mask, -1e9, 0.0) + np.where(pad, -2e9, 0.0)
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dtype).cuda() for a in (q, k, v, bias)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["flash_sdpa", "grouped", "folded", "folded_v3"])
def test_cuda_kernel_matches_plain(name, dtype):
    _need_cuda()
    h, s_q, s_k = 4, 200, 333
    if name in ("folded", "folded_v3"):
        q, k, v, b = _inputs(5, (3, s_q, 128), (3, s_k, 128), h, s_q, s_k, dtype)
        fn = flash_sdpa_folded if name == "folded" else flash_sdpa_folded_v3
        ref = fold(_flash_lib.sdpa_plain(split_view(q, h), split_view(k, h), split_view(v, h), b))
        run = lambda: fn(q, k, v, b, h)  # noqa: E731
    else:
        q, k, v, b = _inputs(5, (3, h, s_q, 32), (3, h, s_k, 32), h, s_q, s_k, dtype)
        fn = flash_sdpa if name == "flash_sdpa" else flash_sdpa_grouped
        ref = _flash_lib.sdpa_plain(q, k, v, b)
        run = lambda: fn(q, k, v, b)  # noqa: E731
    before = sum(_flash_lib.LAUNCHES.values())
    out = run()
    torch.cuda.synchronize()
    assert sum(_flash_lib.LAUNCHES.values()) == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.gpu
def test_cuda_no_bias_and_replayed_bias():
    _need_cuda()
    q, k, v, b = _inputs(6, (2, 3, 4, 70, 64), (2, 3, 4, 90, 64), 4, 70, 90, torch.float32)
    out = flash_sdpa(q, k, v, None)
    torch.testing.assert_close(out, _flash_lib.sdpa_plain(q, k, v), atol=1e-4, rtol=0)
    out = flash_sdpa(q, k, v, b)  # [H, S, S] replayed over the (2, 3) batch
    torch.testing.assert_close(out, _flash_lib.sdpa_plain(q, k, v, b), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_cuda_reference_impl_raises():
    _need_cuda()
    q = torch.zeros(2, 2, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        dot_product_attention(q, q, q, None, impl="reference")
