"""Attention kernels of the PyTorch port against the JAX package's Pallas
kernels.

On the CPU each wrapper of `physdock_tpu_torch/ops/flash_attention*.py`
runs its plain version (einsum + fp32 softmax); here it is held against
the Pallas kernel it replaces, run in interpret mode as
tests/test_flash_attention.py runs it, on the same numpy inputs: fully
masked rows, the -1e9 and -2e9 mask tiers, fp32 and bf16.  The CUDA
kernel itself is compared with the plain version on the card by
tests/test_torch_gpu.py and by chip_smoke.py.

Tolerances: fp32 max abs error 1e-4 (two fp32 summation orders);
bf16 2e-2 (the Pallas kernel widens bf16 inputs to fp32 logits, the plain
version rounds the bf16 einsum, as the JAX `sdpa_xla` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.ops.flash_attention import flash_sdpa as jax_flash_sdpa
from physdock_tpu.ops.flash_attention_folded import flash_sdpa_folded as jax_folded
from physdock_tpu.ops.flash_attention_folded_v3 import flash_sdpa_folded_v3 as jax_folded_v3
from physdock_tpu.ops.flash_attention_grouped import flash_sdpa_grouped as jax_grouped
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops.attention import dot_product_attention, pick_kernel
from physdock_tpu_torch.ops.flash_attention import flash_sdpa
from physdock_tpu_torch.ops.flash_attention_folded import flash_sdpa_folded
from physdock_tpu_torch.ops.flash_attention_folded_v3 import flash_sdpa_folded_v3
from physdock_tpu_torch.ops.flash_attention_grouped import flash_sdpa_grouped

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _masked_bias(rng, h, s_q, s_k):
    """[h, s_q, s_k] bias: random keys at -1e9, the first rows fully
    masked, and the last eighth of the keys at -2e9 on top (pad tier)."""
    bias = rng.normal(size=(h, s_q, s_k)).astype(np.float32)
    mask = rng.random((s_q, s_k)) < 0.2
    mask[: max(1, s_q // 16)] = True
    pad = np.zeros((s_q, s_k), bool)
    pad[:, s_k - s_k // 8:] = True
    return (bias + np.where(mask, -1e9, 0.0) + np.where(pad, -2e9, 0.0)).astype(np.float32)


def _inputs(seed, q_shape, kv_shape, h, s_q, s_k):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=q_shape).astype(np.float32)
    k = rng.normal(size=kv_shape).astype(np.float32)
    v = rng.normal(size=kv_shape).astype(np.float32)
    return q, k, v, _masked_bias(rng, h, s_q, s_k)


def _jax(fn, arrays, dtype, **kw):
    out = fn(*[jnp.asarray(a, JDT[dtype]) for a in arrays], **kw)
    return np.asarray(jnp.asarray(out, jnp.float32))


def _torch(fn, arrays, dtype, *extra):
    out = fn(*[torch.from_numpy(a).to(TDT[dtype]) for a in arrays], *extra)
    return out.float().numpy()


def _check(ref, out, dtype):
    assert np.all(np.isfinite(out))
    err = np.abs(ref - out).max()
    assert err <= TOL[dtype], f"{dtype} max abs err {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sdpa_plain_matches_pallas(dtype):
    # trunk AtomTransformer pattern: [H, S, S] bias replayed over a batch
    arrays = _inputs(0, (2, 2, 128, 32), (2, 2, 256, 32), 2, 128, 256)
    ref = _jax(jax_flash_sdpa, arrays, dtype, interpret=True)
    _check(ref, _torch(flash_sdpa, arrays, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sdpa_grouped_plain_matches_pallas(dtype):
    # token DiT / MSA row pattern: [B, H, S, D], bias [H, S, S] shared over B
    arrays = _inputs(1, (4, 2, 128, 32), (4, 2, 128, 32), 2, 128, 128)
    ref = _jax(jax_grouped, arrays, dtype, interpret=True)
    _check(ref, _torch(flash_sdpa_grouped, arrays, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sdpa_folded_plain_matches_pallas(dtype):
    # triangle attention pattern: folded [B, S, H*D], H=4, D=32
    arrays = _inputs(2, (4, 128, 128), (4, 128, 128), 4, 128, 128)
    ref = _jax(jax_folded, arrays, dtype, n_heads=4, interpret=True)
    _check(ref, _torch(flash_sdpa_folded, arrays, dtype, 4), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_sdpa_folded_v3_plain_matches_pallas(dtype):
    # atom-DiT pattern: folded samples sharing one [4, S, S] bias
    arrays = _inputs(3, (4, 128, 128), (4, 256, 128), 4, 128, 256)
    ref = _jax(jax_folded_v3, arrays, dtype, n_heads=4, interpret=True)
    _check(ref, _torch(flash_sdpa_folded_v3, arrays, dtype, 4), dtype)


@pytest.mark.parametrize(
    "q_shape,k_len,bias_shape,want",
    [
        ((20, 4, 2048, 32), 2048, (4, 2048, 2048), "flash_sdpa_folded_v3"),  # atom DiT
        ((20, 16, 256, 32), 256, (16, 256, 256), "flash_sdpa_grouped"),  # token DiT
        ((128, 8, 256, 32), 256, (8, 256, 256), "flash_sdpa_grouped"),  # MSA row
        ((256, 4, 256, 32), 256, (4, 256, 256), "flash_sdpa_folded"),  # triangle
        ((4, 2048, 32), 2048, (4, 2048, 2048), "flash_sdpa"),  # trunk atoms
        ((16, 256, 32), 256, (16, 256, 256), "flash_sdpa"),  # Pairformer single
        ((256, 8, 128, 32), 128, None, "flash_sdpa"),  # MSA column (no bias)
        ((20, 4, 1024, 32), 1024, (20, 4, 1024, 1024), "flash_sdpa"),  # 4-D bias
    ],
)
def test_dispatch_classes(q_shape, k_len, bias_shape, want):
    q = torch.empty(q_shape, device="meta")
    k = torch.empty(q_shape[:-2] + (k_len, q_shape[-1]), device="meta")
    bias = None if bias_shape is None else torch.empty(bias_shape, device="meta")
    assert pick_kernel(q, k, bias) == want


def test_cpu_runs_plain_and_counts_nothing():
    _flash_lib.reset_launches()
    arrays = _inputs(4, (3, 2, 40, 32), (3, 2, 56, 32), 2, 40, 56)
    q, k, v, b = (torch.from_numpy(a) for a in arrays)
    out = dot_product_attention(q, k, v, b)
    ref = dot_product_attention(q, k, v, b, impl="reference")
    assert torch.equal(out, ref)
    assert all(n == 0 for n in _flash_lib.LAUNCHES.values())
    with pytest.raises(ValueError, match="CPU tensor"):
        dot_product_attention(q, k, v, b, impl="flash")
    with pytest.raises(ValueError, match="unknown"):
        dot_product_attention(q, k, v, b, impl="xla")


def test_wrappers_reject_bad_bias():
    q = torch.zeros(2, 2, 8, 32)
    with pytest.raises(ValueError, match="bias"):
        flash_sdpa_grouped(q, q, q, torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match="bias"):
        flash_sdpa_folded(torch.zeros(2, 8, 64), torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
                          torch.zeros(1, 8, 8), 2)
