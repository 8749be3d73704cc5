"""The training attention kernels of the PyTorch port against the JAX
package: `flash_fwd_lse` (forward with softmax stats) and `flash_bwd`, and
the three autograd Functions of `ops/attention.py`.

On the CPU each wrapper runs its plain version; it is held here against
the Pallas kernel it replaces, run in interpret mode as
tests/test_flash_attention.py runs it, on the same numpy inputs (b 3,
h 2, s 256, d 32): a random bias, the last 8 keys and query rows masked
at -1e9 (the masked-row regression of the fused-lse backward), and the
-2e9 pad tier on top.  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.

Limits: fp32 o <= 2e-5 abs, m and l <= 1e-5 relative, dq/dk/dv/dbias
<= 5e-4 abs (the JAX tests' own limits).  bf16 (inputs rounded to bf16,
both sides widen to fp32 and round the outputs once): o, dq, dk, dv
within 1e-2 of max|ref| (about two bf16 ulps), m and l and dbias (fp32
outputs) within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.ops.attention import sdpa_xla
from physdock_tpu.ops.flash_attention_bwd import flash_bwd as jax_flash_bwd
from physdock_tpu.ops.flash_attention_bwd import flash_fwd_lse as jax_flash_fwd_lse
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops.attention import (
    _FoldedDiff,
    _RecomputeDiff,
    dot_product_attention,
    pick_kernel,
)
from physdock_tpu_torch.ops.flash_attention import flash_sdpa
from physdock_tpu_torch.ops.flash_attention_bwd import (
    flash_bwd,
    flash_bwd_plain,
    flash_fwd_lse,
    flash_fwd_lse_plain,
)
from physdock_tpu_torch.ops.flash_attention_grouped import flash_sdpa_grouped

GRAD_TOL = 5e-4


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _case(kind, seed=7, b=3, h=2, s=256, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32) for _ in range(4))
    bias = rng.normal(size=(h, s, s)).astype(np.float32)
    if kind in ("masked", "tier2"):
        pad = np.zeros((s,), np.float32)
        pad[-8:] = 1.0
        bias = 0.5 * bias - 1e9 * pad[None, None, :] - 1e9 * pad[None, :, None]
    if kind == "tier2":
        tier = np.zeros((s,), np.float32)
        tier[-24:-8] = 1.0  # a second block of keys at -2e9 on top
        bias = bias - 2e9 * tier[None, None, :]
    return q, k, v, bias.astype(np.float32), do


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("kind", ["random", "masked", "tier2"])
def test_fwd_lse_and_bwd_plain_match_pallas(kind):
    q, k, v, bias, do = _case(kind)
    jo, jm, jl = jax_flash_fwd_lse(*(jnp.asarray(a) for a in (q, k, v, bias)), interpret=True)
    to, tm, tl = flash_fwd_lse(_t(q), _t(k), _t(v), _t(bias))
    assert to.dtype == torch.float32 and tm.shape == (3, 2, 256) and tl.shape == (3, 2, 256)
    assert np.abs(_np(to) - _np(jo)).max() < 2e-5
    for name, r, o in (("m", jm, tm), ("l", jl, tl)):
        r, o = _np(r), _np(o)
        assert np.all(np.abs(o - r) <= 1e-5 * np.abs(r)), (name, np.abs(o - r).max())

    jg = jax_flash_bwd(*(jnp.asarray(a) for a in (q, k, v, bias)), jo, jm, jl,
                       jnp.asarray(do), interpret=True)
    tg = flash_bwd(_t(q), _t(k), _t(v), _t(bias), to, tm, tl, _t(do))
    for name, r, o in zip(("dq", "dk", "dv", "dbias"), jg, tg):
        assert tuple(o.shape) == tuple(r.shape), name
        err = np.abs(_np(o) - _np(r)).max()
        assert err < GRAD_TOL, (kind, name, err)
    assert tg[3].dtype == torch.float32


def test_fwd_lse_and_bwd_plain_match_pallas_bf16():
    q, k, v, bias, do = _case("masked", seed=9)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias)]
    tx = [_t(a, torch.bfloat16) for a in (q, k, v, bias)]
    jo, jm, jl = jax_flash_fwd_lse(*jx, interpret=True)
    to, tm, tl = flash_fwd_lse(*tx)
    assert to.dtype == torch.bfloat16 and tm.dtype == torch.float32
    ref = _np(jo)
    assert np.abs(_np(to) - ref).max() <= 1e-2 * np.abs(ref).max()
    for r, o in ((jm, tm), (jl, tl)):
        r, o = _np(r), _np(o)
        assert np.all(np.abs(o - r) <= 1e-4 * np.abs(r))
    jg = jax_flash_bwd(*jx, jo, jm, jl, jnp.asarray(do, jnp.bfloat16), interpret=True)
    tg = flash_bwd(*tx, to, tm, tl, _t(do, torch.bfloat16))
    for name, r, o in zip(("dq", "dk", "dv", "dbias"), jg, tg):
        r, o = _np(r), _np(o)
        rel = 1e-4 if name == "dbias" else 1e-2
        assert np.abs(o - r).max() <= rel * np.abs(r).max(), (name, np.abs(o - r).max())
    assert tg[0].dtype == torch.bfloat16 and tg[3].dtype == torch.float32


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    # the plain backward's formulas against autograd through the einsum
    q, k, v, bias, do = _case("tier2", seed=3, s=64)
    tq, tk, tv, tb = (_t(a).requires_grad_(True) for a in (q, k, v, bias))
    o = _flash_lib.sdpa_plain(tq, tk, tv, tb)
    o.backward(_t(do))
    with torch.no_grad():
        o2, m, l = flash_fwd_lse_plain(tq, tk, tv, tb)
        g = flash_bwd_plain(tq, tk, tv, tb, o2, m, l, _t(do))
    for name, r, x in zip(("dq", "dk", "dv", "dbias"), (tq.grad, tk.grad, tv.grad, tb.grad), g):
        err = float((x - r).abs().max())
        assert err < GRAD_TOL, (name, err)


def _grouped_diff(*args):
    return _RecomputeDiff.apply(flash_sdpa_grouped, *args)


def _flash_diff(*args):
    return _RecomputeDiff.apply(flash_sdpa, *args)


# (q shape, bias shape, Function route, forward kernel the dispatcher picks)
FUNCTION_CASES = {
    "folded": ((3, 4, 64, 32), (4, 64, 64), _FoldedDiff.apply, "flash_sdpa_folded"),
    "folded_v3": ((2, 4, 1024, 32), (4, 1024, 1024), _FoldedDiff.apply, "flash_sdpa_folded_v3"),
    "grouped": ((3, 2, 64, 32), (2, 64, 64), _grouped_diff, "flash_sdpa_grouped"),
    "flash": ((2, 48, 32), (2, 48, 48), _flash_diff, "flash_sdpa"),
    "flash_no_bias": ((2, 3, 40, 32), None, _flash_diff, "flash_sdpa"),
}


def _jax_vjp(q, k, v, bias, do):
    args = [jnp.asarray(a) for a in (q, k, v)] + ([] if bias is None else [jnp.asarray(bias)])
    fn = sdpa_xla if bias is not None else (lambda a, b, c: sdpa_xla(a, b, c, None))
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("route", ["dispatcher", "function"])
@pytest.mark.parametrize("case", list(FUNCTION_CASES))
def test_attention_gradients_match_jax_vjp(case, route):
    q_shape, b_shape, fn_apply, kernel = FUNCTION_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v, do = (rng.normal(size=q_shape).astype(np.float32) for _ in range(4))
    bias = None if b_shape is None else rng.normal(size=b_shape).astype(np.float32)
    if bias is not None:
        bias[..., -3:] -= 1e9  # masked keys
        bias[..., :2, :] -= 1e9  # fully masked query rows
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_(True)
    assert pick_kernel(ins[0], ins[1], tb) == kernel
    _flash_lib.reset_launches()
    if route == "dispatcher":
        out = dot_product_attention(*ins, tb)  # CPU: plain version, ordinary autograd
    else:
        out = fn_apply(*ins, tb)
    assert out.requires_grad and out.grad_fn is not None
    out.backward(_t(do))
    assert all(n == 0 for n in _flash_lib.LAUNCHES.values())
    ref = _jax_vjp(q, k, v, bias, do)
    got = [t.grad for t in ins] + ([] if tb is None else [tb.grad])
    for name, r, g in zip(("dq", "dk", "dv", "dbias"), ref, got):
        assert tuple(g.shape) == r.shape, name
        err = float(np.abs(g.numpy() - r).max())
        assert err < GRAD_TOL, (case, route, name, err)


def test_folded_function_casts_the_bias_gradient_to_the_bias_dtype():
    q, k, v, bias, do = _case("random", seed=1, b=2, h=4, s=64)
    ins = [_t(a, torch.bfloat16).requires_grad_(True) for a in (q, k, v, bias)]
    out = _FoldedDiff.apply(*ins)
    out.backward(_t(do, torch.bfloat16))
    assert [t.grad.dtype for t in ins] == [torch.bfloat16] * 4
    assert [tuple(t.grad.shape) for t in ins] == [tuple(t.shape) for t in ins]


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 2, 8, 32)
    with pytest.raises(ValueError, match="bias"):
        flash_fwd_lse(q, q, q, torch.zeros(3, 8, 8))
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_bwd(q[0], q[0], q[0], torch.zeros(2, 8, 8), q, q, q, q)
