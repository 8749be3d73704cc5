"""Tests of the port that need a CUDA card (marker `gpu`; each skips inside
itself when there is none). This file imports nothing of JAX, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Each wrapper launches the CUDA kernel on ragged shapes (neither axis a
multiple of the 64-row tile), with fully masked rows and the -1e9 / -2e9
tiers, and is held against its plain version on the same card tensors:
fp32 max abs error <= 1e-4 with TF32 off, bf16 <= 2e-2, a bias per system
over sample-major rows included (the batched screen's and the batched
redock's sites).  The training pair
(`flash_fwd_lse`, `flash_bwd`) is held the same way at D = 32, 64 and 128,
relative to max|plain| (fp32 1e-4, bf16 2e-2), and its tensor-core design
(D = 32) on ragged lengths, both bias dtypes, batch groups, fully masked
rows with large logits (the dV-sum identity) and a bitwise-repeatable
dbias; the autograd Functions
against autograd through the plain version; and a CUDA wrapper called on
inputs that require grad, outside a Function, must raise.  The confidence
head with the committed confidence weights, on the card through the
kernels against the CPU through their plain versions: its logits at a
small shape with padded tokens (rel 1e-3 of max|cpu|, rows 3 and 4
launched), and the mini-rollout loss and gradient on the corrupt-pose
route (loss rel 1e-4, ||g_card - g_cpu|| <= 1e-3 ||g_cpu||, rows 5-6 on
the tensor-core pair); the rollout route's loss is finite.  Training at
parity with the JAX trainer: a bf16 train step keeps fp32 parameters,
Adam moments and EMA and launches every kernel in bf16; the same step
with each system's forward and backward as CUDA graphs equals it bit for
bit; the trunk with
two recycles (non-zero recycle tensors) on the card within rel 1e-3 of
the CPU; a reference release `params.pt` loads on the card to the `.npz`'s
trunk, bit for bit.
"""

import dataclasses
import math
import os

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


# ----------------------------------------------- the tensor-core forward
# Every call of `_flash_lib.launch` without stats runs flash_fwd_tc (wgmma;
# bf16, or fp32 as three TF32 passes), split over key chunks when the grid
# is small; each case is held against sdpa_plain at the limits above.


def _tc_case(seed, b, h, s_q, s_k, d, dtype, bias_dtype=None, lead="h", folded=False,
             masked_gain=1.0):
    """q/k/v [b, h, s, d] views (folded strides on request), a [lead, s_q,
    s_k] bias with the mask tiers ("h": lead = h, "bh": lead = b*h, None:
    no bias; the first s_q // 16 rows fully masked, their q scaled by
    `masked_gain`), and the plain result."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for s in (s_q, s_k, s_k))
    q[:, : max(1, s_q // 16)] *= masked_gain
    q, k, v = (torch.from_numpy(x).to(dtype).cuda() for x in (q, k, v))
    if folded:
        q, k, v = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    else:
        q, k, v = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    if lead is None:
        return q, k, v, None, 0, _flash_lib.sdpa_plain(q, k, v)
    n = h if lead == "h" else b * h
    bias = rng.normal(size=(n, s_q, s_k)).astype(np.float32)
    mask = rng.random((s_q, s_k)) < 0.2
    mask[: max(1, s_q // 16)] = True  # fully masked rows
    pad = np.zeros((s_q, s_k), bool)
    pad[:, s_k - s_k // 8:] = True
    bias = bias + np.where(mask, -1e9, 0.0) + np.where(pad, -2e9, 0.0)
    bias = torch.from_numpy(bias.astype(np.float32)).to(bias_dtype or dtype).cuda()
    ref_bias = bias if lead == "h" else bias.view(b, h, s_q, s_k)
    return q, k, v, bias, n, _flash_lib.sdpa_plain(q, k, v, ref_bias)


def _check_tc(q, k, v, bias, lead, ref):
    out = _flash_lib.launch(q, k, v, bias, lead)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == q.dtype
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[q.dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
                         ids=["f32-f32", "f32-bf16", "bf16-f32", "bf16-bf16"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_tc_head_dims_and_dtype_pairs(d, dtypes):
    _need_cuda()
    _check_tc(*_tc_case(11, 2, 3, 200, 333, d, dtypes[0], dtypes[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_q,s_k", [(1, 1), (2, 2), (63, 63), (65, 65), (300, 300),
                                     (65, 300), (300, 63), (1, 300)])
def test_tc_ragged_lengths(s_q, s_k, dtype):
    """Neither axis a multiple of the 64-row tile; with b*h = 2 every case
    of more than 64 keys also takes the key split and its combine."""
    _need_cuda()
    _check_tc(*_tc_case(12, 1, 2, s_q, s_k, 32, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", ["h", "bh", None])
@pytest.mark.parametrize("folded", [False, True], ids=["split", "folded"])
def test_tc_bias_lead_and_strides(folded, lead, dtype):
    _need_cuda()
    _check_tc(*_tc_case(13, 3, 4, 130, 190, 32, dtype, lead=lead, folded=folded))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("folded", [False, True], ids=["split", "folded"])
def test_tc_bias_per_system_sample_major(folded, dtype):
    """A bias per system shared by that system's samples (batched
    screening): rows sample-major (row b = n * g + system) over a [g, H, S,
    S] bias, lead g * H strictly between H and B * H; through the wrapper
    of each layout, against each system's rows with its own bias."""
    _need_cuda()
    n, g, h, s_q, s_k = 4, 3, 4, 130, 190
    q, k, v, bias, _, _ = _tc_case(15, n * g, h, s_q, s_k, 32, dtype, lead="bh", folded=folded)
    bias = bias[: g * h].reshape(g, h, s_q, s_k)
    ref = torch.empty_like(q)
    for i in range(g):
        ref[i::g] = _flash_lib.sdpa_plain(q[i::g], k[i::g], v[i::g], bias[i])
    _flash_lib.reset_launches()
    if folded:
        out = split_view(flash_sdpa_folded_v3(fold(q), fold(k), fold(v), bias, h), h)
    else:
        out = flash_sdpa_grouped(q, k, v, bias)
    torch.cuda.synchronize()
    assert sum(_flash_lib.LAUNCHES.values()) == 1 and not any(_flash_lib.BIAS_EXPANSIONS.values())
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,s", [("folded", 896), ("folded_v3", 2048)])
def test_tc_batched_redock_per_system_bias(name, s, dtype):
    """The batched redock's atom-DiT site (`--dock_batch_size 4`): 4
    systems re-padded to the chunk's largest bucket (896 atoms at crop
    128/1024, row 3; 2048 at crop 256/2048, row 1), 20 samples each, rows
    sample-major, one [4, H, S, S] bias per system whose padded key columns
    (-2e9) start where that system's atoms end; against each system's
    rows with its own bias."""
    _need_cuda()
    n, g, h, d = 20, 4, 4, 32
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.normal(size=(n * g, s, h * d)).astype(np.float32))
               .to(dtype).cuda() for _ in range(3))
    bias = rng.normal(size=(g, h, s, s)).astype(np.float32)
    for i, cut in enumerate((0, 32, 64, 100)):
        bias[i, :, :, s - cut:] = -2e9
    bias = torch.from_numpy(bias).to(dtype).cuda()
    qs, ks, vs = (split_view(x, h) for x in (q, k, v))
    ref = torch.empty_like(qs)
    for i in range(g):
        ref[i::g] = _flash_lib.sdpa_plain(qs[i::g], ks[i::g], vs[i::g], bias[i])
    wrapper = flash_sdpa_folded_v3 if name == "folded_v3" else flash_sdpa_folded
    _flash_lib.reset_launches()
    out = split_view(wrapper(q, k, v, bias, h), h)
    torch.cuda.synchronize()
    assert _flash_lib.LAUNCHES[f"flash_sdpa_{name}"] == 1
    assert not any(_flash_lib.BIAS_EXPANSIONS.values())
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.gpu
def test_stacked_relaxation_is_bitwise_repeatable():
    """The guided sampler's force-field relaxation over a stacked field
    (every dock is a group of one) differentiates through the per-system
    atom lookup: on the card its gradient must sum in a fixed order, so
    that a system docks to the same poses in every run (dock_many against
    one dock after the other)."""
    _need_cuda()
    from physdock_tpu_torch.model.forcefield import (
        build_ligand_ff,
        relax_positions,
        stack_ligand_ffs,
    )

    rng = np.random.default_rng(17)
    ffs = []
    for n in (24, 30):
        ref = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
        bonds = [(i, i + 1) for i in range(n - 1)] + [(0, 5), (3, 9)]
        ffs.append(build_ligand_ff([6] * n, bonds, ref, device="cuda"))
    ff = stack_ligand_ffs(ffs)
    pos = torch.from_numpy(rng.normal(size=(2, 20, 30, 3)).astype(np.float32) * 2.0).cuda()
    runs = [relax_positions(pos, ff, iters=20) for _ in range(3)]
    assert bool(torch.isfinite(runs[0]).all()) and float((runs[0] - pos).abs().max()) > 1e-3
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


@pytest.mark.gpu
def test_tc_masked_rows_with_large_logits():
    """|s * scale| beyond 32 (half an ulp of 1e9) on fully masked rows: the
    logit rounds to a neighbour of -1e9 there, as in the plain version."""
    _need_cuda()
    q, k, v, bias, lead, ref = _tc_case(14, 2, 2, 150, 260, 32, torch.float32, masked_gain=12.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(32)
    assert float(s[:, :, :9].abs().max()) > 32
    _check_tc(q, k, v, bias, lead, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_key_split_at_the_trunk_shape(dtype):
    """B*H = 4, S = 2048 (the trunk atom transformer): 128 query tiles, cut
    into key chunks and combined."""
    _need_cuda()
    assert _flash_lib.key_split(1, 4, 2048, 2048, _flash_lib._sm_count("cuda"))[0] > 1
    _check_tc(*_tc_case(15, 1, 4, 2048, 2048, 32, dtype))


# ------------------------------------------ the tensor-core training pair
# flash_fwd_tc with stats, then dq_dbias_tc and dkdv_tc (D = 32 and 64):
# held against the plain versions relative to max|plain| at the limits
# above, on the folded strides of the training call sites.


def _pair_case(seed, b, h, s_q, s_k, dtype, bias_dtype=None, masked_gain=1.0):
    q, k, v, bias, _, _ = _tc_case(seed, b, h, s_q, s_k, 32, dtype, bias_dtype, folded=True,
                                   masked_gain=masked_gain)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn((b, s_q, h, 32), generator=g, device="cuda").to(dtype).permute(0, 2, 1, 3)
    return q, k, v, bias, do


def _groups(b, h, s_q, dtype, bias_dtype=None):
    codes = _flash_lib._DTYPE_CODE
    slots = _flash_lib.dq_slots(codes[dtype], codes[bias_dtype or dtype], 32, True, "cuda")
    return _flash_lib.bwd_groups(b, h, s_q, slots)


def _run_pair(q, k, v, bias, do):
    _flash_lib.reset_launches()
    o, m, l = flash_fwd_lse(q, k, v, bias)
    grads = flash_bwd(q, k, v, bias, o, m, l, do)
    torch.cuda.synchronize()
    assert _flash_lib.ROUTES == {"fwd_lse_tc": 1, "fwd_lse_simt": 0, "bwd_tc": 1, "bwd_simt": 0}
    return (o, m, l), grads


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
                         ids=["f32-f32", "f32-bf16", "bf16-f32", "bf16-bf16"])
@pytest.mark.parametrize("s_q,s_k", [(1, 63), (63, 63), (65, 65), (300, 300), (65, 300), (300, 63)])
def test_tc_pair_ragged_lengths_and_dtypes(s_q, s_k, dtypes):
    """Neither axis a multiple of the 64-row tile, S_q != S_k, folded
    strides; with B 3 and H 4 the dq/dbias kernel runs three batch groups.
    (S_k = 1 is left out: there P = 1, so dq, dk and dbias are exactly 0
    and an error relative to max|plain| compares rounding noise.)"""
    _need_cuda()
    dtype = dtypes[0]
    q, k, v, bias, do = _pair_case(21, 3, 4, s_q, s_k, dtype, dtypes[1])
    assert _groups(3, 4, s_q, dtype, dtypes[1]) > 1
    (o, m, l), grads = _run_pair(q, k, v, bias, do)
    ro, rm, rl = flash_fwd_lse_plain(q, k, v, bias)
    ref = flash_bwd_plain(q, k, v, bias, o, m, l, do)
    tol = TOL[dtype]
    assert _rel_err(o, ro) <= tol, _rel_err(o, ro)
    for x, r in ((m, rm), (l, rl)):
        assert bool(((x - r).abs() <= 1e-5 * r.abs()).all())
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        assert x.shape == r.shape and bool(torch.isfinite(x).all()), name
        assert _rel_err(x, r) <= tol, (name, _rel_err(x, r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_pair_masked_rows_with_large_logits(dtype):
    """Fully masked rows with |s * scale| > 32, where one ulp of a -1e9
    logit is 64: the backward's logits must be the forward's to the bit, or
    P there is off by e^64. Every output finite, every P row sums to 1, so
    sum_j dV[b, h, j] = sum_i dO[b, h, i]."""
    _need_cuda()
    q, k, v, bias, do = _pair_case(22, 2, 4, 150, 260, dtype, masked_gain=12.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(32)
    assert float(s[:, :, :9].abs().max()) > 32
    (o, m, l), grads = _run_pair(q, k, v, bias, do)
    assert all(bool(torch.isfinite(x).all()) for x in (o, m, l, *grads))
    want = do.float().sum(-2)
    err = float((grads[2].float().sum(-2) - want).abs().max() / want.abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else TOL[dtype]), err
    ref = flash_bwd_plain(q, k, v, bias, o, m, l, do)
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        assert _rel_err(x, r) <= TOL[dtype], (name, _rel_err(x, r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_pair_dbias_is_bitwise_repeatable(dtype):
    """dbias is summed over B with one writer per element and the batch
    groups added in order: two runs give the same bits."""
    _need_cuda()
    q, k, v, bias, do = _pair_case(23, 9, 4, 200, 333, dtype)
    assert _groups(9, 4, 200, dtype) > 1
    (o, m, l), first = _run_pair(q, k, v, bias, do)
    _, second = _run_pair(q, k, v, bias, do)
    assert torch.equal(first[3], second[3])
    assert all(torch.equal(a, b) for a, b in zip(first[:3], second[:3]))


# ------------------------------------------------------------ confidence

CONF_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "_confidence", "ema_params_conf.npz")


def _conf_setup(device, seed=2):
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.model.physdock import PhysDock, prepare_batch
    from physdock_tpu_torch.model.weights import load_jax_params

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    model = PhysDock(cfg.model, with_confidence=True)
    load_jax_params(model, CONF_NPZ)
    batch = make_synthetic_batch(n_tokens=40, n_atoms=160, n_msa=4, n_ligand_tokens=8, seed=seed,
                                 pad_tokens=8, pad_atoms=32)
    b = prepare_batch({k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()})
    return cfg, model.to(device), b


@pytest.mark.gpu
def test_confidence_head_on_card_matches_cpu():
    _need_cuda()
    rng = np.random.default_rng(0)
    x = None
    outs, launches = {}, {}
    for dev in ("cpu", "cuda"):
        _, model, b = _conf_setup(dev)
        if x is None:  # two poses around the GT, 3 A of noise
            x_gt = b["x_gt"].cpu().numpy()
            x = x_gt[None] + rng.normal(size=(2,) + x_gt.shape) * 3.0
        with torch.no_grad():
            _, _, s, z = model.eval().conditioning(b)
            _flash_lib.reset_launches()
            outs[dev] = [t.float().cpu() for t in model.confidence(
                b, s, z, torch.as_tensor(x, dtype=torch.float32, device=dev))]
        launches[dev] = dict(_flash_lib.LAUNCHES)
    for name, o, r in zip(("p_pae", "p_pde", "p_plddt"), outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(o).all()), name
        err = float((o - r).abs().max() / r.abs().max())
        assert err <= 1e-3, (name, err)
    assert launches["cuda"]["flash_sdpa_folded"] > 0 and launches["cuda"]["flash_sdpa"] > 0
    assert not any(launches["cpu"].values())


def _mini_rollout_grads(device, corrupt, steps=12):
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import make_train_step

    cfg, model, b = _conf_setup(device)
    loss_cfg = dataclasses.replace(cfg.loss, alpha_pae=1.0, alpha_confidence=1.0)
    step = make_train_step(model, make_optimizer(), loss_cfg, use_mini_rollout=True,
                           mini_rollout_steps=steps, corrupt_rollout_pose=corrupt)
    d = step.draw_system(b, 3, 0, 0)
    loss, logs = step.loss_fn(b, d)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
             for (n, p), g in zip(named, grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}, grads


@pytest.mark.gpu
def test_mini_rollout_gradient_on_card_matches_cpu():
    _need_cuda()
    _flash_lib.reset_launches()
    card = _mini_rollout_grads("cuda", corrupt=True)
    routes = dict(_flash_lib.ROUTES)
    cpu = _mini_rollout_grads("cpu", corrupt=True)
    assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0]), (card[0], cpu[0])
    assert {"plddt_loss", "pae_loss", "pde_loss"} <= set(card[1])
    diff = math.sqrt(sum(float(((card[2][n] - g) ** 2).sum()) for n, g in cpu[2].items()))
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in cpu[2].values()))
    assert diff <= 1e-3 * norm, (diff, norm)
    dead = [n for n, g in card[2].items()
            if n.startswith("confidence_module.") and not float(g.abs().max()) > 0]
    assert not dead, dead
    assert routes["fwd_lse_tc"] > 0 and routes["bwd_tc"] > 0, routes
    assert routes["fwd_lse_simt"] == 0 and routes["bwd_simt"] == 0, routes


@pytest.mark.gpu
def test_mini_rollout_route_on_card_is_finite():
    _need_cuda()
    loss, logs, grads = _mini_rollout_grads("cuda", corrupt=False, steps=3)
    assert math.isfinite(loss) and all(math.isfinite(v) for v in logs.values()), logs
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_overfit",
                   "ema_params.npz")


def _toy_batch(device, seed=4, n_tokens=40, n_atoms=160):
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.model.physdock import prepare_batch

    batch = make_synthetic_batch(n_tokens=n_tokens, n_atoms=n_atoms, n_msa=4, n_ligand_tokens=8,
                                 seed=seed, pad_tokens=8, pad_atoms=32)
    return prepare_batch({k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()})


def _bf16_step(device):
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2, bf16=True)
    model = load_model(NPZ, cfg).to(device)
    opt = make_optimizer()
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, cfg.loss, sigma_data=cfg.model.sigma_data)
    batch = {k: v[None] for k, v in _toy_batch(device).items()}
    state, logs = step(state, batch, 0)
    return state, logs


@pytest.mark.gpu
def test_bf16_train_step_on_card_keeps_fp32_state_and_launches_bf16():
    """One bf16 train step of the toy model on the card: finite losses,
    fp32 parameters, Adam moments and EMA that moved, every kernel launch
    in bf16 and rows 5-6 on the tensor-core pair."""
    _need_cuda()
    _flash_lib.reset_launches()
    state, logs = _bf16_step("cuda")
    dtypes, routes = dict(_flash_lib.DTYPES), dict(_flash_lib.ROUTES)
    assert all(math.isfinite(v) for v in logs.values()), logs
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu, state.ema_params):
        assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                   for t in tree.values())
    assert sum(float(t.abs().sum()) for t in state.opt_state.mu.values()) > 0
    assert dtypes["float32"] == 0 and dtypes["bfloat16"] > 0, dtypes
    assert routes["fwd_lse_tc"] > 0 and routes["bwd_tc"] > 0, routes
    assert routes["fwd_lse_simt"] == 0 and routes["bwd_simt"] == 0, routes



@pytest.mark.gpu
def test_graphed_train_step_on_card_equals_eager():
    """The bf16 toy step with each system's forward and backward replayed
    as CUDA graphs (`make_train_step(cuda_graph=True)`) against the eager
    step from one init, under deterministic algorithms: 3 steps over two
    systems of different shapes (a graph each, the first one replayed
    again in step 3), every loss term and every parameter bit for bit."""
    _need_cuda()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, eager_logs = _toy_graph_steps(False)
        graphed, graph_logs = _toy_graph_steps(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert graph_logs == eager_logs
    assert all(math.isfinite(v) for lg in eager_logs for v in lg.values())
    for n, p in eager.params.items():
        assert torch.equal(p, graphed.params[n]), n


def _toy_graph_steps(graph):
    """3 bf16 toy steps over two systems of different shapes, graphed or
    eager, from one init: the state and each step's logs."""
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2, bf16=True)
    batches = [{k: v[None] for k, v in _toy_batch("cuda", seed=s, n_tokens=n, n_atoms=a).items()}
               for s, n, a in ((4, 40, 160), (5, 48, 192))]
    model = load_model(NPZ, cfg).to("cuda")
    opt = make_optimizer()
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, cfg.loss, sigma_data=cfg.model.sigma_data,
                           cuda_graph=graph)
    logs = []
    for i in range(3):
        state, lg = step(state, batches[i % 2], 0)
        logs.append(lg)
    return state, logs


@pytest.mark.gpu
def test_graphed_train_step_under_the_profiler_equals_eager():
    """The program's spans are host-only: the graphed toy step captured and
    replayed while a profiler session records CPU and CUDA activity (every
    span on) equals the eager step run without one, bit for bit under
    deterministic algorithms, and the trace holds the step's spans."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, eager_logs = _toy_graph_steps(False)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graphed, graph_logs = _toy_graph_steps(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert graph_logs == eager_logs
    for n, p in eager.params.items():
        assert torch.equal(p, graphed.params[n]), n
    names = {e.name for e in prof.events()}
    assert {"physdock.train.step", "physdock.train.forward", "physdock.train.backward",
            "physdock.trunk", "physdock.denoise"} <= names


@pytest.mark.gpu
def test_recycled_trunk_on_card_matches_cpu():
    """The toy trunk with two recycles and non-zero recycle projections, on
    the card through the kernels against the CPU through the plain
    versions: s and z within rel 1e-3 of max|cpu|."""
    _need_cuda()
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.train.checkpoint import load_params_npz

    model = PhysDock(dataclasses.replace(PhysDockConfig.named("toy").model, num_recycles=2))
    sd = load_params_npz(NPZ)
    rng = np.random.default_rng(21)
    for n, t in model.state_dict().items():
        if ".recycle_" in n:
            a = (1.0 + 0.2 * rng.normal(size=t.shape) if "norm" in n
                 else 0.05 * rng.normal(size=t.shape))
            sd[n] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd)
    outs = {}
    for dev in ("cpu", "cuda"):
        with torch.no_grad():
            _, _, s, z = model.to(dev).eval().conditioning(_toy_batch(dev))
        outs[dev] = (s.float().cpu(), z.float().cpu())
    for name, o, r in zip(("s", "z"), outs["cuda"], outs["cpu"]):
        err = float((o - r).abs().max() / r.abs().max())
        assert err <= 1e-3, (name, err)


@pytest.mark.gpu
def test_reference_pt_docks_on_card_as_the_npz(tmp_path):
    """The toy weights written as a reference release `params.pt` load on
    the card to the same weights as the `.npz`, and give the same trunk."""
    _need_cuda()
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.train.checkpoint import load_params_npz

    sd = load_params_npz(NPZ)
    path = str(tmp_path / "params.pt")
    torch.save({"model." + k.replace("time_embedder.linear_", "time_embedder.timestep_embedder."
                                     "linear_"): v for k, v in sd.items()}, path)
    cfg = PhysDockConfig.named("toy")
    outs = []
    for p in (NPZ, path):
        model = load_model(p, cfg).cuda().eval()
        with torch.no_grad():
            outs.append([t.cpu() for t in model.conditioning(_toy_batch("cuda"))])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
