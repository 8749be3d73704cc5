"""The arithmetic of the tensor-core forward (`csrc/flash_fwd.cu`,
`flash_fwd_tc`), modelled in plain torch on the CPU and held to the plain
version, and the host side of that kernel:

- fp32 runs every product as three TF32 passes, hi*hi + hi*lo + lo*hi with
  hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi). At the atom-DiT
  length (S 2048, D 32) with fully masked rows, the -1e9 keys and the -2e9
  tier, that stays within the 1e-4 that chip_smoke.py holds the card to;
  one TF32 pass does not.
- The key split: the plain versions of its two kernels (`split_plain`,
  `combine_plain`) give the unsplit `sdpa_plain` for 1 to 4 chunks, fully
  masked rows included, and `key_split` cuts only small grids, into
  non-empty chunks of a multiple of 64 keys.
- The build: a library is rebuilt when a header its source includes is
  newer, and a failing `nvcc` raises.
- The tensor-core backward (`csrc/flash_bwd.cu`, `dq_dbias_tc` and
  `dkdv_tc`): its logits rounded as the forward rounds them, P from the
  forward's m and l, and dP, dQ, dK and dV each in three TF32 passes, held
  to `flash_bwd_plain` at S 1024; one pass on any of the four products
  misses the limit, which is why each takes three.
- The pairing: `launch(stats=True)` and `launch_bwd` both ask `tc_pair`
  which design to run, and pass it to the kernels.
- The dq/dbias kernel's batch groups: the fewest waves times samples per
  block, no empty group.
- The dV-sum identity sum_j dV_j = sum_i dO_i (every P row sums to 1), on
  the plain path and on the emulated tensor-core path, masked rows with
  large logits included.
"""

import math
import os

import numpy as np
import pytest
import torch

from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops.flash_attention_bwd import flash_bwd_plain, flash_fwd_lse_plain

TOL_FP32 = 1e-4  # chip_smoke.py's fp32 limit


def tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a, b, passes):
    """a @ b as the kernel runs it: products of TF32 values (exact in
    fp32), fp32 sums; three passes or one."""
    ah, al = split(a)
    bh, bl = split(b)
    out = ah @ bh
    if passes == 3:
        out = out + ah @ bl + al @ bh
    return out


def sdpa_tf32(q, k, v, bias, passes):
    """The kernel's fp32 path: logits = (q k^T) * scale + bias, fp32
    softmax, and p @ v, both products in TF32 passes."""
    logits = mm_tf32(q, k.transpose(-1, -2), passes) * (1.0 / math.sqrt(q.shape[-1])) + bias
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    return mm_tf32(p, v, passes) / p.sum(-1, keepdim=True)


def _inputs(seed, h, s_q, s_k, d):
    """q/k/v [h, s, d] and a [h, s_q, s_k] bias with the mask tiers of
    chip_smoke.py: random keys at -1e9, the first s_q // 16 rows fully
    masked, the last eighth of the keys at -2e9 on top."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(h, s, d)).astype(np.float32) for s in (s_q, s_k, s_k))
    bias = rng.normal(size=(h, s_q, s_k)).astype(np.float32)
    mask = rng.random((s_q, s_k)) < 0.2
    mask[: max(1, s_q // 16)] = True
    pad = np.zeros((s_q, s_k), bool)
    pad[:, s_k - s_k // 8:] = True
    bias = (bias + np.where(mask, -1e9, 0.0) + np.where(pad, -2e9, 0.0)).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, bias)]


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    for sign in (1.0, -1.0):
        x = sign * (one + ulp / 2)  # a tie: away from zero
        assert float(tf32_rna(x)) == sign * (1.0 + ulp)
        x = sign * (one + ulp / 2 - 2.0 ** -23)  # below the tie: down
        assert float(tf32_rna(x)) == sign * 1.0
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi, lo = split(x)
    assert bool((tf32_rna(hi) == hi).all()) and bool((tf32_rna(lo) == lo).all())
    # hi + lo keeps 22 of fp32's 24 bits
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


def test_three_tf32_passes_hold_the_fp32_limit_at_the_atom_dit_length():
    q, k, v, bias = _inputs(1, 2, 2048, 2048, 32)
    ref = _flash_lib.sdpa_plain(q, k, v, bias)
    err3 = float((sdpa_tf32(q, k, v, bias, 3) - ref).abs().max())
    err1 = float((sdpa_tf32(q, k, v, bias, 1) - ref).abs().max())
    assert err3 <= TOL_FP32 / 20, err3
    assert err1 > TOL_FP32, err1  # why one pass is not enough


@pytest.mark.parametrize("s_k,key_chunk,chunks", [(180, 192, 1), (180, 128, 2), (180, 64, 3), (250, 64, 4)])
def test_split_and_combine_match_the_unsplit_softmax(s_k, key_chunk, chunks):
    q, k, v, bias = _inputs(2, 3, 70, s_k, 32)
    o_part, m_part, l_part = _flash_lib.split_plain(q, k, v, bias, key_chunk)
    assert o_part.shape == (chunks, 3, 70, 32) and m_part.shape == l_part.shape == (chunks, 3, 70)
    out = _flash_lib.combine_plain(o_part, m_part, l_part)
    ref = _flash_lib.sdpa_plain(q, k, v, bias)
    assert bool(torch.isfinite(out).all())
    # the fully masked rows softmax over their bias, as in the plain version
    torch.testing.assert_close(out[:, :4], ref[:, :4], atol=1e-6, rtol=0)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,want", [
    ((1, 4, 2048, 2048), (3, 704)),    # trunk atom transformer: 128 query tiles
    ((20, 4, 2048, 2048), (1, 2048)),  # atom DiT: 2560 tiles fill the card
    ((1, 16, 256, 256), (4, 64)),      # Pairformer single attention
    ((256, 8, 2, 2), (1, 2)),          # MSA columns: one key tile
    ((48, 16, 256, 256), (1, 256)),    # token DiT
    ((1, 2, 65, 300), None),
    ((3, 4, 200, 333), None),
    ((1, 1, 1, 65), None),
])
def test_key_split_cuts_only_small_grids(shape, want):
    b, h, s_q, s_k = shape
    n_split, key_chunk = _flash_lib.key_split(b, h, s_q, s_k, 132)
    if want is not None:
        assert (n_split, key_chunk) == want
    tiles = b * h * -(-s_q // 64)
    if n_split > 1:
        assert tiles < 2 * 132 and key_chunk % 64 == 0
        assert (n_split - 1) * key_chunk < s_k <= n_split * key_chunk  # none empty
    else:
        assert key_chunk == s_k


def _fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\nint x;\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    (csrc / "unused.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_flash_lib, "SOURCES", {"k": str(csrc / "k.cu")})
    monkeypatch.setattr(_flash_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_flash_lib, "BUILD_LOG", {"k": {"seconds": None, "ptxas": ""}})
    return csrc


def test_a_newer_included_header_rebuilds(tmp_path, monkeypatch):
    csrc = _fake_tree(tmp_path, monkeypatch)
    assert sorted(os.path.basename(f) for f in _flash_lib.source_files("k")) == ["a.cuh", "b.cuh", "k.cu"]
    assert not _flash_lib._fresh("k")
    os.makedirs(_flash_lib.BUILD_DIR)
    lib = _flash_lib.lib_path("k")
    with open(lib, "w"):
        pass
    for f in csrc.iterdir():
        os.utime(f, (1_000, 1_000))
    os.utime(lib, (2_000, 2_000))
    assert _flash_lib._fresh("k")
    os.utime(csrc / "unused.cuh", (3_000, 3_000))  # not included: no rebuild
    assert _flash_lib._fresh("k")
    os.utime(csrc / "b.cuh", (3_000, 3_000))  # included through a.cuh
    assert not _flash_lib._fresh("k")


def test_a_failing_nvcc_raises(tmp_path, monkeypatch):
    _fake_tree(tmp_path, monkeypatch)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'k.cu(3): error: forced failure'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_flash_lib, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match="forced failure"):
        _flash_lib.build_all(force=True)
    assert not os.path.exists(_flash_lib.lib_path("k"))


# ------------------------------------------------ the tensor-core backward

PRODUCTS = ("dp", "dq", "dk", "dv")


def logits_tc(q, k, bias):
    """flash_tc.cuh `logits` in fp32: three TF32 passes of Q K^T, then
    fl(s * scale), then fl(+ bias)."""
    return mm_tf32(q, k.transpose(-1, -2), 3) * (1.0 / math.sqrt(q.shape[-1])) + bias


def fwd_lse_tc(q, k, v, bias):
    """The tensor-core forward with stats: o, the row max m and the sum l."""
    x = logits_tc(q, k, bias)
    m = x.amax(-1)
    p = torch.exp(x - m[..., None])
    l = p.sum(-1)
    return mm_tf32(p, v, 3) / l[..., None], m, l


def bwd_tc(q, k, v, bias, o, m, l, do, passes):
    """dq_dbias_tc and dkdv_tc: the forward's logits, P = exp(x - m) * (1/l),
    dS = P (dP - delta), each product in `passes[name]` TF32 passes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(logits_tc(q, k, bias) - m[..., None]) * (1.0 / l[..., None])
    delta = (do * o).sum(-1)
    ds = p * (mm_tf32(do, v.transpose(-1, -2), passes["dp"]) - delta[..., None])
    dq = mm_tf32(ds, k, passes["dq"]) * scale
    dk = mm_tf32(ds.transpose(-1, -2), q, passes["dk"]) * scale
    dv = mm_tf32(p.transpose(-1, -2), do, passes["dv"])
    return dq, dk, dv, ds.sum(0)


def _rel(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def bwd_case():
    """[1, 2, 1024, 32] with chip_smoke.py's mask tiers, dO, and the
    emulated forward's o, m, l; the plain backward at those stats."""
    q, k, v, bias = _inputs(3, 2, 1024, 1024, 32)
    q, k, v = (x[None] for x in (q, k, v))
    do = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    o, m, l = fwd_lse_tc(q, k, v, bias)
    return (q, k, v, bias, o, m, l, do), flash_bwd_plain(q, k, v, bias, o, m, l, do)


def test_three_tf32_passes_hold_the_backward_limit(bwd_case):
    args, ref = bwd_case
    out = bwd_tc(*args, dict.fromkeys(PRODUCTS, 3))
    for name, x, r in zip(("dq", "dk", "dv", "dbias"), out, ref):
        assert bool(torch.isfinite(x).all()), name
        assert _rel(x, r) <= TOL_FP32 / 20, (name, _rel(x, r))


@pytest.mark.parametrize("product", PRODUCTS)
def test_one_tf32_pass_of_any_backward_product_misses_the_limit(bwd_case, product):
    args, ref = bwd_case
    passes = dict.fromkeys(PRODUCTS, 3)
    passes[product] = 1
    out = bwd_tc(*args, passes)
    worst = max(_rel(x, r) for x, r in zip(out, ref))
    assert worst > TOL_FP32, (product, worst)


@pytest.mark.parametrize("path", ["plain", "tc"])
def test_dv_sums_to_the_do_sum(path):
    """sum_j dV[b, h, j] = sum_i dO[b, h, i]: each row of P sums to 1, the
    fully masked rows (their q scaled so that |s * scale| > 32) too."""
    q, k, v, bias = _inputs(5, 2, 300, 260, 32)
    q[:, :18] *= 12.0
    q, k, v = (x[None] for x in (q, k, v))
    assert float((q[..., :18, :] @ k.transpose(-1, -2)).abs().max()) / math.sqrt(32) > 32
    do = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))
    if path == "plain":
        o, m, l = flash_fwd_lse_plain(q, k, v, bias)
        dv = flash_bwd_plain(q, k, v, bias, o, m, l, do)[2]
    else:
        o, m, l = fwd_lse_tc(q, k, v, bias)
        dv = bwd_tc(q, k, v, bias, o, m, l, do, dict.fromkeys(PRODUCTS, 3))[2]
    want = do.sum(-2)
    assert bool(torch.isfinite(dv).all())
    assert float((dv.sum(-2) - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_tc_pair_covers_d32_and_d64_in_both_dtypes():
    for dtype in (torch.float32, torch.bfloat16):
        assert _flash_lib.tc_pair(dtype, 32) and _flash_lib.tc_pair(dtype, 64)
        assert not _flash_lib.tc_pair(dtype, 128)


@pytest.mark.parametrize("pair,simt", [(True, None), (False, None), (True, True)])
def test_launch_and_launch_bwd_read_one_pairing(monkeypatch, pair, simt):
    """Both launchers ask `tc_pair` (unless told `simt`) and hand the same
    choice to the forward (`simt` flag) and to the backward (`tc` flag);
    the kernels are replaced by a recorder, so no card is needed."""
    asked, flags = [], {}

    class Lib:
        @staticmethod
        def flash_fwd(*args):
            flags["fwd_simt"] = args[-1]
            return 0

        @staticmethod
        def flash_fwd_split(*args):
            raise AssertionError("this grid is not split")

        @staticmethod
        def flash_bwd(*args):
            flags["bwd_tc"] = args[-1]
            return 0

        @staticmethod
        def flash_bwd_dq_blocks_per_sm(*args):
            return 2

    def fake_pair(dtype, d):
        asked.append((dtype, d))
        return pair

    monkeypatch.setattr(_flash_lib, "tc_pair", fake_pair)
    monkeypatch.setattr(_flash_lib, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(_flash_lib, "_stream", lambda device: 0)
    monkeypatch.setattr(_flash_lib, "_sm_count", lambda device: 132)
    monkeypatch.setattr(_flash_lib, "_load", lambda name: Lib)
    monkeypatch.setattr(_flash_lib, "_DQ_BLOCKS", {})
    _flash_lib.reset_launches()
    q = torch.zeros(64, 4, 128, 32)  # 512 query tiles: one key chunk
    bias = torch.zeros(4, 128, 128)
    o, m, l = _flash_lib.launch(q, q, q, bias, 4, stats=True, simt=simt)
    assert o.shape == q.shape and m.shape == l.shape == (64, 4, 128)
    _flash_lib.launch_bwd(q, q, q, bias, m, l, torch.zeros_like(m), q, simt=simt)
    use_tc = pair and not simt
    assert asked == ([] if simt else [(torch.float32, 32)] * 2)
    assert flags == {"fwd_simt": int(not use_tc), "bwd_tc": int(use_tc)}
    want = "tc" if use_tc else "simt"
    assert _flash_lib.ROUTES == {"fwd_lse_tc": 0, "fwd_lse_simt": 0, "bwd_tc": 0, "bwd_simt": 0,
                                 f"fwd_lse_{want}": 1, f"bwd_{want}": 1}
    _flash_lib.launch(q, q, q, bias, 4)  # without stats: always the tensor cores
    assert flags["fwd_simt"] == 0 and len(asked) == (0 if simt else 2)


@pytest.mark.parametrize("shape,slots,want", [
    ((48, 4, 2048), 2 * 132, 2),   # atom DiT, 2 blocks per SM: one wave of 256 blocks
    ((48, 4, 2048), 3 * 132, 3),   # atom DiT, 3 per SM: one wave of 384
    ((256, 4, 256), 2 * 132, 16),  # triangle: 256 blocks of 16 samples
    ((1, 4, 2048), 264, 1),
    ((3, 4, 200), 264, 3),
    ((9, 4, 200), 264, 9),
])
def test_bwd_groups_take_the_fewest_sample_waves(shape, slots, want):
    b, h, s_q = shape
    g = _flash_lib.bwd_groups(b, h, s_q, slots)
    assert g == want
    per = -(-b // g)
    assert (g - 1) * per < b <= g * per  # every group non-empty
    tiles = h * -(-s_q // 64)
    cost = -(-tiles * g // slots) * per
    for other in range(1, b + 1):
        p = -(-b // other)
        assert cost <= -(-tiles * -(-b // p) // slots) * p
