"""Build, load and launch the hand-written Hopper attention kernels.

Each `.cu` under `csrc/` (`flash_fwd.cu`: the forward, with or without
softmax stats; `flash_bwd.cu`: the backward) is compiled with `nvcc` into `build/lib<name>.so` at the repo
root the first time a wrapper launches it, and again when the source or
a header it includes from `csrc/` is newer (plain C interface, bound with
ctypes; no PyTorch headers, so a build takes seconds).  `build_all`
starts one `nvcc` per source at once.  Every wrapper in
`ops/flash_attention*.py` goes through `launch` or `launch_bwd`, which
check what the kernels take and raise on anything else.

The forward with stats and the backward come as a pair, because the
backward recomputes the forward's logits to the bit: `tc_pair` chooses,
per (dtype, head dim), the tensor-core pair (`flash_fwd_tc` with stats,
then `dq_dbias_tc` and `dkdv_tc`) or the SIMT pair, and both `launch`
(with stats) and `launch_bwd` ask it. An explicit `simt=True` takes the
SIMT pair, for timing it against the tensor cores.

A kernel writes into fresh tensors, so what it returns has no `grad_fn`.
Called with grad mode on and an input that requires grad, `launch` and
`launch_bwd` raise rather than silently cut the gradient: the
`torch.autograd.Function`s of `ops/attention.py` call them with grad mode
off.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import re
import shutil
import subprocess
import time
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {
    "flash_fwd": os.path.join(_PKG, "csrc", "flash_fwd.cu"),
    "flash_bwd": os.path.join(_PKG, "csrc", "flash_bwd.cu"),
}
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HEAD_DIMS = (32, 64, 128)
BQ = 64  # query rows per forward block (flash_fwd.cu)
KEY_CHUNK_UNIT = 64  # key chunks of the split forward are multiples of this
BQ_BWD = 64  # query rows per dq/dbias block (flash_bwd.cu)
TC_PAIR_DIMS = (32, 64)  # head dims of the tensor-core backward (flash_bwd.cu dispatch_d)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
# kernel launches per wrapper; a wrapper adds one only where it launches
LAUNCHES = {
    "flash_sdpa": 0,
    "flash_sdpa_grouped": 0,
    "flash_sdpa_folded": 0,
    "flash_sdpa_folded_v3": 0,
    "flash_fwd_lse": 0,
    "flash_bwd": 0,
}
# launches per design of the training pair, to show which one a run took
ROUTES = {"fwd_lse_tc": 0, "fwd_lse_simt": 0, "bwd_tc": 0, "bwd_simt": 0}
# kernel launches (forward and backward) per q dtype, to show a run's precision
DTYPES = {"float32": 0, "bfloat16": 0}
# per wrapper: biases it expanded to one block per (batch, head) before a
# launch, a copy of B*H*S_q*S_k elements (`flash_attention._bias_lead`)
BIAS_EXPANSIONS = dict.fromkeys(LAUNCHES, 0)
# per source: nvcc seconds and the -Xptxas -v report
BUILD_LOG = {name: {"seconds": None, "ptxas": ""} for name in SOURCES}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, DTYPES, BIAS_EXPANSIONS):
        for name in counts:
            counts[name] = 0


def tc_pair(dtype: torch.dtype, d: int) -> bool:
    """Whether the forward with stats and the backward run on the tensor
    cores (else both on the SIMT kernels): a fixed choice per (dtype, head
    dim), never a fallback. Both dtypes at D = 32 and 64; D = 128 does not
    fit the tensor-core backward's registers and shared memory."""
    return dtype in _DTYPE_CODE and d in TC_PAIR_DIMS


def _use_simt(dtype, d: int, simt) -> bool:
    return (not tc_pair(dtype, d)) if simt is None else bool(simt)


def _require_cuda(*tensors) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the flash kernels take CUDA tensors only")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str):
    """The source of `name` and every file it includes with `#include "..."`
    (resolved beside the including file, recursively)."""
    todo, seen = [SOURCES[name]], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            text = f.read()
        todo += [os.path.join(os.path.dirname(path), inc) for inc in _INCLUDE.findall(text)]
    return seen


def _fresh(name: str) -> bool:
    path = lib_path(name)
    return os.path.exists(path) and all(
        os.path.getmtime(path) >= os.path.getmtime(src) for src in source_files(name))


def build_all(force: bool = False, names=None) -> Dict[str, str]:
    """Compile every kernel library that is missing or older than its
    source, one `nvcc` per source, all started together. Returns the
    library paths; each compiler's `-Xptxas -v` report (registers, shared
    memory, spills) lands in BUILD_LOG."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or not _fresh(n)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.time()
        procs = {}
        for n in todo:
            tmp = lib_path(n) + f".tmp{os.getpid()}"
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[n]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[n]["seconds"] = time.time() - t0
            BUILD_LOG[n]["ptxas"] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {SOURCES[n]}:\n{out}")
            else:
                os.replace(tmp, lib_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: lib_path(n) for n in names}


def build(name: str = "flash_fwd", force: bool = False) -> str:
    return build_all(force, [name])[name]


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(build(name))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        strided = [p, i64, i64, i64]
        if name == "flash_fwd":
            lib.flash_fwd.argtypes = (
                [i32, i32, i32] + strided * 4 + [p, p]
                + [p, i64, i64, i32]
                + [i32, i32, i32, i32, ctypes.c_float, p, i32]
            )
            lib.flash_fwd.restype = i32
            lib.flash_fwd_split.argtypes = (
                [i32, i32, i32] + strided * 4
                + [p, i64, i64, i32]
                + [i32, i32, i32, i32, ctypes.c_float]
                + [i32, i32, p, p, p, p, p, p]
            )
            lib.flash_fwd_split.restype = i32
        else:
            lib.flash_bwd.argtypes = (
                [i32, i32, i32] + strided * 4 + [p, p, p, p] + strided * 3 + [p, p]
                + [i32, i32, i32, i32, i32, ctypes.c_float, p, i32]
            )
            lib.flash_bwd.restype = i32
            lib.flash_bwd_dq_blocks_per_sm.argtypes = [i32, i32, i32, i32]
            lib.flash_bwd_dq_blocks_per_sm.restype = i32
        _libs[name] = lib
    return _libs[name]


def records_grad(*tensors) -> bool:
    """Grad mode is on and an input requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def check_no_grad(*tensors) -> None:
    """Raise when autograd records the call: the kernel's output would
    carry no `grad_fn`, and the gradient would stop here."""
    if records_grad(*tensors):
        raise RuntimeError(
            "a CUDA attention kernel was called on inputs that require grad with grad "
            "mode on; its output would have no grad_fn. Go through "
            "ops.attention.dot_product_attention (its autograd.Functions) or torch.no_grad()")


def _bhsd_strides(x: torch.Tensor):
    return x.stride(0), x.stride(1), x.stride(2)


def launch(q, k, v, bias, lead: int, stats: bool = False, simt=None):
    """Launch the forward kernel on [B, H, S, D] views of q/k/v (any strides
    with a contiguous D axis). `bias` is None or a contiguous [lead, S_q,
    S_k] tensor whose row-block `(b*H + h) % lead` serves (b, h). Returns a
    new [B, H, S_q, D] tensor, stored folded ([B, S, H, D] memory) when q
    is. This is the tensor-core kernel, over the key chunks of `key_split`
    (fp32 partials merged by a second kernel). With `stats` it also
    returns the fp32 row max m and normalizer l [B, H, S_q], from the
    forward of the pair `tc_pair` chooses: the tensor-core kernel or, for
    the SIMT pair or with `simt=True`, the SIMT kernel."""
    check_no_grad(q, k, v, bias)
    _require_cuda(q, k, v)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"unsupported q/k/v dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("launch takes [B, H, S, D] views")
    B, H, S_q, D = q.shape
    S_k = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, H, S_k, D) or v.shape != (B, H, S_k, D):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} head dim must be contiguous, strides {x.stride()}")
    if B * H >= 2**31 or S_k == 0:
        raise ValueError(f"unsupported extent B*H={B * H}, S_k={S_k}")
    # output in q's layout: folded [B, S, H, D] memory when q is folded
    if q.stride(1) == D and q.stride(2) == H * D:
        o = torch.empty((B, S_q, H, D), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
    else:
        o = torch.empty((B, H, S_q, D), device=q.device, dtype=q.dtype)
    if bias is not None:
        _require_cuda(bias)
        if bias.dtype not in _DTYPE_CODE:
            raise TypeError(f"bias must be a float32/bfloat16 CUDA tensor, got {bias.dtype}")
        if bias.dim() != 3 or tuple(bias.shape) != (lead, S_q, S_k):
            raise ValueError(f"bias shape {tuple(bias.shape)} != {(lead, S_q, S_k)}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
        b_args = (bias.data_ptr(), bias.stride(0), bias.stride(1), lead)
        b_code = _DTYPE_CODE[bias.dtype]
    else:
        b_args = (None, 0, 0, 0)
        b_code = 0
    if simt and not stats:
        raise ValueError("the SIMT forward runs only with stats")
    use_simt = stats and _use_simt(q.dtype, D, simt)
    lib = _load("flash_fwd")
    stream = _stream(q.device)
    qkvo = (q.data_ptr(), *_bhsd_strides(q), k.data_ptr(), *_bhsd_strides(k),
            v.data_ptr(), *_bhsd_strides(v), o.data_ptr(), *_bhsd_strides(o))
    scale = 1.0 / math.sqrt(D)
    m = l = None
    if stats:
        m = torch.empty((B, H, S_q), device=q.device, dtype=torch.float32)
        l = torch.empty_like(m)
        ROUTES["fwd_lse_simt" if use_simt else "fwd_lse_tc"] += 1
    ml = (None, None) if m is None else (m.data_ptr(), l.data_ptr())
    n_split, key_chunk = (1, S_k) if use_simt else key_split(B, H, S_q, S_k, _sm_count(q.device))
    if n_split == 1:
        err = lib.flash_fwd(_DTYPE_CODE[q.dtype], b_code, D, *qkvo, *ml,
                            *b_args, B, H, S_q, S_k, scale, stream, int(use_simt))
    else:
        # one fp32 scratch: o_part [n_split, B*H, S_q, D], then m_part, l_part
        rows = n_split * B * H * S_q
        part = torch.empty(rows * (D + 2), device=q.device, dtype=torch.float32)
        ptr = part.data_ptr()
        err = lib.flash_fwd_split(
            _DTYPE_CODE[q.dtype], b_code, D, *qkvo, *b_args, B, H, S_q, S_k, scale,
            key_chunk, n_split, ptr, ptr + rows * D * 4, ptr + rows * (D + 1) * 4, stream, *ml)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    DTYPES[str(q.dtype).replace("torch.", "")] += 1
    return (o, m, l) if stats else o


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device) -> int:
    """SMs of the card (cached: the property query costs tens of
    microseconds, as much as a small launch)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def key_split(B: int, H: int, S_q: int, S_k: int, sms: int):
    """(n_split, key_chunk) of the tensor-core forward: when its
    B*H*ceil(S_q/64) warpgroups (one per 64 query rows) are fewer than two
    per SM, the keys are cut into chunks of a multiple of 64 keys, enough
    for about two warpgroups per SM, every chunk non-empty; else one chunk
    of all S_k keys."""
    tiles = B * H * -(-S_q // BQ)
    units = -(-S_k // KEY_CHUNK_UNIT)
    want = min(units, -(-2 * sms // tiles))
    if want <= 1:
        return 1, S_k
    key_chunk = -(-units // want) * KEY_CHUNK_UNIT
    return -(-S_k // key_chunk), key_chunk


@functools.lru_cache(maxsize=None)
def bwd_groups(B: int, H: int, S_q: int, slots: int) -> int:
    """Batch groups G of the dq/dbias kernel, each a run of consecutive
    samples whose fp32 dbias partial its blocks own alone; never an empty
    group. Its H * ceil(S_q/64) * G blocks each walk their samples one
    after another, so with `slots` blocks on the card at once it takes
    about ceil(blocks / slots) waves of ceil(B / G) samples: the G of the
    least product, the smallest of equals (the partials are G * H * S_q *
    S_k fp32)."""
    tiles = H * -(-S_q // BQ_BWD)
    best = None
    for g in range(1, B + 1):
        per = -(-B // g)
        g = -(-B // per)  # no empty group
        cost = -(-tiles * g // slots) * per
        if best is None or cost < best[0]:
            best = (cost, g)
    return best[1]


_DQ_BLOCKS: Dict[tuple, int] = {}


def dq_slots(dtype_code: int, bias_code: int, d: int, tc: bool, device) -> int:
    """Blocks of the dq/dbias kernel the card holds at once: its occupancy
    per SM (asked of the CUDA runtime once per kernel) times the SMs."""
    key = (dtype_code, bias_code, d, tc)
    if key not in _DQ_BLOCKS:
        _DQ_BLOCKS[key] = max(1, _load("flash_bwd").flash_bwd_dq_blocks_per_sm(*key[:3], int(tc)))
    return _DQ_BLOCKS[key] * _sm_count(device)


def launch_bwd(q, k, v, bias, m, l, delta, do, simt=None):
    """Launch the backward kernels: q/k/v/do are [B, H, S, D] views (any
    strides, contiguous D), bias a contiguous [H, S_q, S_k], m/l/delta fp32
    [B, H, S_q] (m and l from `launch(stats=True)` with the same `simt`).
    Returns (dq, dk, dv) in q's dtype and layout, and dbias fp32 [H, S_q,
    S_k] summed over B. The tensor-core or the SIMT pair, as `tc_pair`
    chooses or `simt` says."""
    check_no_grad(q, k, v, bias, m, l, delta, do)
    _require_cuda(q, k, v, bias, m, l, delta, do)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in (k, v, do)):
        raise TypeError(f"unsupported q/k/v/do dtypes {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if q.dim() != 4:
        raise ValueError("launch_bwd takes [B, H, S, D] views")
    B, H, S_q, D = q.shape
    S_k = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if k.shape != (B, H, S_k, D) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do {tuple(do.shape)}")
    if do.stride(3) != 1:
        do = do.contiguous()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} head dim must be contiguous, strides {x.stride()}")
    if bias.dtype not in _DTYPE_CODE or tuple(bias.shape) != (H, S_q, S_k) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32/bfloat16 {(H, S_q, S_k)} tensor, "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        if x.dtype != torch.float32 or tuple(x.shape) != (B, H, S_q) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {(B, H, S_q)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if S_k == 0 or S_q == 0 or B * H >= 2**31:
        raise ValueError(f"unsupported extent B*H={B * H}, S_q={S_q}, S_k={S_k}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((H, S_q, S_k), device=q.device, dtype=torch.float32)
    use_simt = _use_simt(q.dtype, D, simt)
    codes = (_DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype], D)
    groups = bwd_groups(B, H, S_q, dq_slots(*codes, not use_simt, q.device))
    part = (torch.empty((groups, H, S_q, S_k), device=q.device, dtype=torch.float32)
            if groups > 1 else dbias)
    ROUTES["bwd_simt" if use_simt else "bwd_tc"] += 1
    err = _load("flash_bwd").flash_bwd(
        *codes,
        q.data_ptr(), *_bhsd_strides(q),
        k.data_ptr(), *_bhsd_strides(k),
        v.data_ptr(), *_bhsd_strides(v),
        do.data_ptr(), *_bhsd_strides(do),
        bias.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *_bhsd_strides(dq),
        dk.data_ptr(), *_bhsd_strides(dk),
        dv.data_ptr(), *_bhsd_strides(dv),
        part.data_ptr(), dbias.data_ptr(),
        B, H, S_q, S_k, groups, 1.0 / math.sqrt(D), _stream(q.device), int(not use_simt),
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
    DTYPES[str(q.dtype).replace("torch.", "")] += 1
    return dq, dk, dv, dbias


def sdpa_plain(q, k, v, bias=None):
    """The plain PyTorch version of every kernel: einsum + fp32 softmax,
    exactly the JAX package's `sdpa_xla`. q/k/v: [..., S, D]."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", probs.to(q.dtype), v)


def shared_bias(bias, batch: int, h: int, s_q: int, s_k: int):
    """A bias shared over the batch axis of q [B, H, S_q, D]: [H, S_q,
    S_k], one for every row, or [G, H, S_q, S_k], one per system, with the
    rows laid out sample-major (row b takes block b % G). Returns the
    [G*H, S_q, S_k] contiguous form and the kernel's lead G*H, under which
    the kernel's row-block index (b*H + h) % lead is (b % G)*H + h."""
    g = bias.shape[0] if bias.dim() == 4 else 1
    if bias.dim() not in (3, 4) or tuple(bias.shape[-3:]) != (h, s_q, s_k) or batch % g:
        raise ValueError(f"bias {tuple(bias.shape)} is neither {(h, s_q, s_k)} nor "
                         f"[G, {h}, {s_q}, {s_k}] with G dividing the batch {batch}")
    return bias.reshape(g * h, s_q, s_k).contiguous(), g * h


def shared_plain(q, k, v, bias):
    """The plain version under a `shared_bias` bias: q/k/v [B, H, S, D]
    seen as [B/G, G, H, S, D] against a [G, H, S_q, S_k] bias."""
    if bias.dim() == 3:
        return sdpa_plain(q, k, v, bias)
    g = bias.shape[0]
    return sdpa_plain(*(x.unflatten(0, (-1, g)) for x in (q, k, v)), bias).flatten(0, 1)


def split_plain(q, k, v, bias, key_chunk: int):
    """The plain version of the split forward's first kernel: per chunk z
    of `key_chunk` keys, the unnormalized o_z = exp(s - m_z) @ v, the
    chunk's row max m_z and sum l_z, all fp32. Returns ([Z, ..., S_q, D],
    [Z, ..., S_q], [Z, ..., S_q])."""
    d = q.shape[-1]
    logits = torch.einsum("...qd,...kd->...qk", q, k).float() * (1.0 / math.sqrt(d))
    if bias is not None:
        logits = logits + bias.float()
    parts = []
    for z0 in range(0, k.shape[-2], key_chunk):
        s = logits[..., z0:z0 + key_chunk]
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((torch.einsum("...qk,...kd->...qd", p, v[..., z0:z0 + key_chunk, :].float()),
                      m, p.sum(-1)))
    return tuple(torch.stack(x) for x in zip(*parts))


def combine_plain(o_part, m_part, l_part):
    """The plain version of the combine kernel: o = sum_z o_z w_z /
    sum_z l_z w_z with w_z = exp(m_z - max_z m_z), m and l kept apart."""
    w = torch.exp(m_part - m_part.amax(0))
    return (o_part * w[..., None]).sum(0) / (l_part * w).sum(0)[..., None]
