"""Scaled-dot-product attention with an additive bias: the single entry
point of every attention module (port of `physdock_tpu/ops/attention.py`).

  * `sdpa_reference` -- einsum + fp32 softmax, the JAX package's
    `sdpa_xla`; the plain version of every kernel.
  * the four forward kernel wrappers in `ops/flash_attention*.py`, all
    backed by the hand-written Hopper kernel `csrc/flash_fwd.cu`, and the
    training pair `flash_fwd_lse` / `flash_bwd` in
    `ops/flash_attention_bwd.py` (`csrc/flash_fwd.cu` with stats,
    `csrc/flash_bwd.cu`).

`dot_product_attention` routes each call by the classes of the JAX
dispatcher (`_flash_pick`): a [H, S, S] bias shared over a batch of 4-D
q goes to the folded kernels when H*D = 128 (v3 for S_k >= 1024), else
to the grouped one; everything else to `flash_sdpa`.  On CUDA every call
goes to a kernel; the TPU's tiling gates do not apply, since the kernel
masks ragged tiles itself.  A wrapper given CPU tensors runs its plain
version.

Under autograd (grad mode on and an input that requires grad), a CUDA
call goes through one of two `torch.autograd.Function`s, the
counterparts of the JAX package's three `custom_vjp`s:

  * `_FoldedDiff` (the folded classes, H*D = 128): forward
    `flash_fwd_lse`, backward the `flash_bwd` kernels;
  * `_RecomputeDiff` (the grouped and per-(b, h) classes): forward the
    grouped or per-(b, h) kernel, backward autograd through
    `sdpa_reference`, recomputed.

So under grad the folded forward kernels (rows 1 and 3) do not launch, as
in JAX. On the CPU every route stays the plain version with ordinary
autograd.

Layout: q, k, v are [..., H, S, D]; bias is broadcastable to
[..., H, S, S]. Softmax statistics are always fp32.
"""

from __future__ import annotations

import torch

from physdock_tpu_torch.ops._flash_lib import records_grad
from physdock_tpu_torch.ops._flash_lib import sdpa_plain as sdpa_reference
from physdock_tpu_torch.ops.flash_attention import flash_sdpa
from physdock_tpu_torch.ops.flash_attention_bwd import flash_bwd, flash_fwd_lse
from physdock_tpu_torch.ops.flash_attention_folded import (
    flash_sdpa_folded_from_split,
    fold,
    split_view,
)
from physdock_tpu_torch.ops.flash_attention_folded_v3 import flash_sdpa_folded_v3
from physdock_tpu_torch.ops.flash_attention_grouped import flash_sdpa_grouped

__all__ = ["dot_product_attention", "sdpa_reference", "pick_kernel"]


def pick_kernel(q, k, bias) -> str:
    """Name of the wrapper that serves this call site."""
    if (
        bias is not None
        and bias.dim() == 3
        and q.dim() == 4
        and q.shape[0] > 1
        and tuple(bias.shape) == (q.shape[1], q.shape[2], k.shape[2])
    ):
        if q.shape[1] * q.shape[3] == 128:
            return "flash_sdpa_folded_v3" if k.shape[2] >= 1024 else "flash_sdpa_folded"
        return "flash_sdpa_grouped"
    return "flash_sdpa"


def _run_kernel(q, k, v, bias):
    name = pick_kernel(q, k, bias)
    if name == "flash_sdpa_folded_v3":
        h = q.shape[1]
        o = flash_sdpa_folded_v3(fold(q), fold(k), fold(v), bias, h)
        return split_view(o, h)
    if name == "flash_sdpa_folded":
        return flash_sdpa_folded_from_split(q, k, v, bias)
    if name == "flash_sdpa_grouped":
        return flash_sdpa_grouped(q, k, v, bias)
    return flash_sdpa(q, k, v, bias)


class _FoldedDiff(torch.autograd.Function):
    """Forward with stats (row 5), fused backward kernels (row 6)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, m, l = flash_fwd_lse(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, m, l)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, m, l = ctx.saved_tensors
        dq, dk, dv, db = flash_bwd(q, k, v, bias, o, m, l, g.to(q.dtype))
        return dq, dk, dv, db.to(bias.dtype)


class _RecomputeDiff(torch.autograd.Function):
    """Forward: the given kernel wrapper (row 2 or 4); backward: the
    gradients of `sdpa_reference` at the saved inputs, recomputed (the JAX
    package's `jax.vjp(sdpa_xla)` backward): no probabilities are kept
    from the forward."""

    @staticmethod
    def forward(ctx, wrapper, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return wrapper(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[1:])]
            o = sdpa_reference(*inputs)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(o, wrt, g))
        return (None, *(next(grads) if t is not None and t.requires_grad else None
                         for t in inputs))


def _run_function(q, k, v, bias):
    name = pick_kernel(q, k, bias)
    if name in ("flash_sdpa_folded", "flash_sdpa_folded_v3"):
        return _FoldedDiff.apply(q, k, v, bias)
    if name == "flash_sdpa_grouped":
        return _RecomputeDiff.apply(flash_sdpa_grouped, q, k, v, bias)
    return _RecomputeDiff.apply(flash_sdpa, q, k, v, bias)


def dot_product_attention(q, k, v, bias=None, impl: str = "auto"):
    """impl: "auto" (the picked wrapper: kernel on CUDA, plain version on
    CPU), "flash" (a kernel; raises on CPU tensors) or "reference" (the
    plain version; raises on CUDA tensors, so a kernel run cannot silently
    become a reference run)."""
    if impl == "reference":
        if q.is_cuda:
            raise ValueError("impl='reference' on a CUDA tensor: the kernels serve CUDA")
        return sdpa_reference(q, k, v, bias)
    if impl == "flash":
        if not q.is_cuda:
            raise ValueError("impl='flash' requested on a CPU tensor: the kernels run on CUDA only")
    if impl in ("flash", "auto"):
        if q.is_cuda and records_grad(q, k, v, bias):
            return _run_function(q, k, v, bias)
        return _run_kernel(q, k, v, bias)
    raise ValueError(f"unknown attention impl: {impl}")
