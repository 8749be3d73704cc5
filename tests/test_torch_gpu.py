"""Tests of the port that need a CUDA card (marker `gpu`; each skips inside
itself when there is none). This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Each wrapper launches the CUDA kernel on ragged shapes (neither axis a
multiple of the 64-row tile), with fully masked rows and the -1e9 / -2e9
tiers, and is held against its plain version on the same card tensors:
fp32 max abs error <= 1e-4 with TF32 off, bf16 <= 2e-2.  The training pair
(`flash_fwd_lse`, `flash_bwd`) is held the same way at D = 32, 64 and 128,
relative to max|plain| (fp32 1e-4, bf16 2e-2); the autograd Functions
against autograd through the plain version; and a CUDA wrapper called on
inputs that require grad, outside a Function, must raise.
"""

import numpy as np
import pytest
import torch

from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops.attention import dot_product_attention
from physdock_tpu_torch.ops.flash_attention import flash_sdpa
from physdock_tpu_torch.ops.flash_attention_bwd import (
    flash_bwd,
    flash_bwd_plain,
    flash_fwd_lse,
    flash_fwd_lse_plain,
)
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


def _rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_cuda_fwd_lse_and_bwd_match_plain(d, dtype):
    _need_cuda()
    b, h, s_q, s_k = 3, 4, 200, 333  # ragged: neither a multiple of a tile
    q, k, v, bias = _inputs(7, (b, h, s_q, d), (b, h, s_k, d), h, s_q, s_k, dtype)
    do = torch.randn((b, s_q, h, d), device="cuda").to(dtype).permute(0, 2, 1, 3)
    if d == 32:  # the folded layout of the training call sites, as strides
        q, k, v = (x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) for x in (q, k, v))
    _flash_lib.reset_launches()
    o, m, l = flash_fwd_lse(q, k, v, bias)
    dq, dk, dv, db = flash_bwd(q, k, v, bias, o, m, l, do)
    torch.cuda.synchronize()
    assert _flash_lib.LAUNCHES["flash_fwd_lse"] == 1 and _flash_lib.LAUNCHES["flash_bwd"] == 1
    ro, rm, rl = flash_fwd_lse_plain(q, k, v, bias)
    ref = flash_bwd_plain(q, k, v, bias, o, m, l, do)
    tol = TOL[dtype]
    assert o.dtype == dtype and m.dtype == torch.float32 and db.dtype == torch.float32
    assert _rel_err(o, ro) <= tol
    for x, r in ((m, rm), (l, rl)):
        assert bool(((x - r).abs() <= 1e-5 * r.abs()).all())
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), (dq, dk, dv, db), ref):
        assert x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert _rel_err(x, r) <= tol, (name, _rel_err(x, r))


@pytest.mark.gpu
def test_cuda_wrapper_on_requires_grad_inputs_raises():
    _need_cuda()
    q = torch.randn(2, 2, 64, 32, device="cuda", requires_grad=True)
    bias = torch.randn(2, 64, 64, device="cuda")
    with pytest.raises(RuntimeError, match="grad_fn"):
        flash_sdpa(q, q, q, None)
    with pytest.raises(RuntimeError, match="grad_fn"):
        flash_sdpa_grouped(q, q, q, bias)
    with pytest.raises(RuntimeError, match="grad_fn"):
        flash_fwd_lse(q, q, q, bias)
    with torch.no_grad():
        assert flash_sdpa(q, q, q, None).shape == q.shape


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["folded", "grouped", "flash"])
def test_cuda_attention_gradients_match_plain_autograd(case):
    _need_cuda()
    shapes = {"folded": ((3, 4, 130, 32), (4, 130, 130)),
              "grouped": ((3, 2, 130, 32), (2, 130, 130)),
              "flash": ((2, 130, 32), (2, 130, 130))}
    q_shape, b_shape = shapes[case]
    g = torch.Generator(device="cuda").manual_seed(3)
    leaves = [torch.randn(q_shape, generator=g, device="cuda").requires_grad_(True) for _ in range(3)]
    bias = torch.randn(b_shape, generator=g, device="cuda")
    bias[..., :4, :] -= 1e9
    bias = bias.requires_grad_(True)
    do = torch.randn(q_shape, generator=g, device="cuda")
    _flash_lib.reset_launches()
    dot_product_attention(*leaves, bias).backward(do)
    torch.cuda.synchronize()
    launched = {k for k, n in _flash_lib.LAUNCHES.items() if n}
    want = {"folded": {"flash_fwd_lse", "flash_bwd"}, "grouped": {"flash_sdpa_grouped"},
            "flash": {"flash_sdpa"}}[case]
    assert launched == want
    got = [t.grad for t in leaves + [bias]]
    ref_in = [t.detach().requires_grad_(True) for t in leaves + [bias]]
    _flash_lib.sdpa_plain(*ref_in).backward(do)
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), got, [t.grad for t in ref_in]):
        assert _rel_err(x, r) <= 1e-4, (name, _rel_err(x, r))
