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
to the grouped one; everything else to `flash_sdpa`.  A system axis
(q [N, Bsys, H, S, D] with one [Bsys, H, S, S] bias per system, as the
batched sampler's DiT gives it) takes the class of one system's shapes,
where `jax.vmap` leaves the JAX dispatcher: the wrapper then runs the N *
Bsys rows, sample-major, over the per-system bias with lead Bsys * H.
On CUDA every call goes to a kernel; the TPU's tiling gates do not
apply, since the kernel masks ragged tiles itself.  A wrapper given CPU
tensors runs its plain version.

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

Under pair-row tensor parallelism (`parallel/tp.py`), a call whose q holds
all S_q rows but whose bias holds this rank's S_q/tp rows (MSA rows,
single attention and the DiT, from a row-sharded z or bias cache) goes to
`_tp_sharded_flash`: the rank's q rows and bias rows take the same route
as any call, against all keys, and the output rows are gathered.

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
from physdock_tpu_torch.parallel.tp import current_tp_mesh, gather_rows, row_range

__all__ = ["dot_product_attention", "sdpa_reference", "pick_kernel"]


def pick_kernel(q, k, bias) -> str:
    """Name of the wrapper that serves this call site: q [N, H, S, D] with
    a bias [H, S_q, S_k] shared by the N > 1 rows, or q [N, Bsys, H, S, D]
    with a bias [Bsys, H, S_q, S_k], are the shared-bias classes."""
    if (
        bias is not None
        and bias.dim() in (3, 4)
        and q.dim() == bias.dim() + 1
        and q.shape[0] > 1
        and tuple(bias.shape) == tuple(q.shape[1:-1]) + (k.shape[-2],)
    ):
        if q.shape[-3] * q.shape[-1] == 128:
            return "flash_sdpa_folded_v3" if k.shape[-2] >= 1024 else "flash_sdpa_folded"
        return "flash_sdpa_grouped"
    return "flash_sdpa"


def _run_kernel(q, k, v, bias):
    name = pick_kernel(q, k, bias)
    if name == "flash_sdpa":
        return flash_sdpa(q, k, v, bias)
    # the shared-bias classes: samples (and systems) as one sample-major batch
    lead = q.shape[:-3]
    q, k, v = (x.flatten(0, -4) for x in (q, k, v))
    if name == "flash_sdpa_folded_v3":
        h = q.shape[1]
        o = split_view(flash_sdpa_folded_v3(fold(q), fold(k), fold(v), bias, h), h)
    elif name == "flash_sdpa_folded":
        o = flash_sdpa_folded_from_split(q, k, v, bias)
    else:
        o = flash_sdpa_grouped(q, k, v, bias)
    return o.unflatten(0, lead)


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


# calls of the row-sharded route, one per call (not per launch)
TP_FLASH_CALLS = [0]


def _tp_sharded_flash(q, k, v, bias, impl, mesh):
    """This rank's S_q/tp query rows against all keys, then the rows of
    every rank gathered. Softmax is row-local: no collective inside."""
    lo, hi = row_range(q.shape[-2], mesh)
    o = dot_product_attention(q[..., lo:hi, :], k, v, bias, impl)
    TP_FLASH_CALLS[0] += 1
    return gather_rows(o, -2, mesh)


def dot_product_attention(q, k, v, bias=None, impl: str = "auto"):
    """impl: "auto" (the picked wrapper: kernel on CUDA, plain version on
    CPU), "flash" (a kernel; raises on CPU tensors) or "reference" (the
    plain version; raises on CUDA tensors, so a kernel run cannot silently
    become a reference run)."""
    mesh = current_tp_mesh()
    if mesh is not None and bias is not None and bias.shape[-2] * mesh.tp == q.shape[-2]:
        return _tp_sharded_flash(q, k, v, bias, impl, mesh)
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
