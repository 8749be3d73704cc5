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
"""

import math
import os

import numpy as np
import pytest
import torch

from physdock_tpu_torch.ops import _flash_lib

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
