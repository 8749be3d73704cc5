"""Build, load and launch the hand-written Hopper attention kernels.

Each `.cu` under `csrc/` (`flash_fwd.cu`: the forward, with optional
softmax stats; `flash_bwd.cu`: the backward) is compiled with `nvcc` into
`build/lib<name>.so` at the repo root the first time a wrapper launches
it (plain C interface, bound with ctypes; no PyTorch headers, so a build
takes seconds).  `build_all` starts one `nvcc` per source at once.  Every
wrapper in `ops/flash_attention*.py` goes through `launch` or
`launch_bwd`, which check what the kernels take and raise on anything
else.

A kernel writes into fresh tensors, so what it returns has no `grad_fn`.
Called with grad mode on and an input that requires grad, `launch` and
`launch_bwd` raise rather than silently cut the gradient: the
`torch.autograd.Function`s of `ops/attention.py` call them with grad mode
off.
"""

from __future__ import annotations

import ctypes
import math
import os
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
BQ_BWD = 64  # query rows per dq/dbias block (flash_bwd.cu)
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
# per source: nvcc seconds and the -Xptxas -v report
BUILD_LOG = {name: {"seconds": None, "ptxas": ""} for name in SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _fresh(name: str) -> bool:
    path = lib_path(name)
    return os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(SOURCES[name])


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
                + [i32, i32, i32, i32, ctypes.c_float, p]
            )
            lib.flash_fwd.restype = i32
        else:
            lib.flash_bwd.argtypes = (
                [i32, i32, i32] + strided * 4 + [p, p, p, p] + strided * 3 + [p, p]
                + [i32, i32, i32, i32, i32, ctypes.c_float, p]
            )
            lib.flash_bwd.restype = i32
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


def launch(q, k, v, bias, lead: int, stats: bool = False):
    """Launch the forward kernel on [B, H, S, D] views of q/k/v (any strides
    with a contiguous D axis). `bias` is None or a contiguous [lead, S_q,
    S_k] tensor whose row-block `(b*H + h) % lead` serves (b, h). Returns a
    new [B, H, S_q, D] tensor, stored folded ([B, S, H, D] memory) when q
    is; with `stats`, also the fp32 row max m and normalizer l [B, H, S_q]."""
    check_no_grad(q, k, v, bias)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the flash kernel takes CUDA tensors only")
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
        if not bias.is_cuda or bias.dtype not in _DTYPE_CODE:
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
    if stats:
        m = torch.empty((B, H, S_q), device=q.device, dtype=torch.float32)
        l = torch.empty_like(m)
        ml = (m.data_ptr(), l.data_ptr())
    else:
        ml = (None, None)
    lib = _load("flash_fwd")
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], b_code, D,
        q.data_ptr(), *_bhsd_strides(q),
        k.data_ptr(), *_bhsd_strides(k),
        v.data_ptr(), *_bhsd_strides(v),
        o.data_ptr(), *_bhsd_strides(o),
        *ml,
        *b_args,
        B, H, S_q, S_k, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    return (o, m, l) if stats else o


def bwd_groups(B: int, H: int, S_q: int, device) -> int:
    """Batch groups of the dq/dbias kernel: enough (h, query tile, group)
    blocks for two per SM, each group a run of consecutive samples whose
    fp32 dbias partial it owns alone; never an empty group."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = H * -(-S_q // BQ_BWD)
    g = min(B, max(1, -(-2 * sms // tiles)))
    per = -(-B // g)
    return -(-B // per)


def launch_bwd(q, k, v, bias, m, l, delta, do):
    """Launch the backward kernels: q/k/v/do are [B, H, S, D] views (any
    strides, contiguous D), bias a contiguous [H, S_q, S_k], m/l/delta fp32
    [B, H, S_q]. Returns (dq, dk, dv) in q's dtype and layout, and dbias
    fp32 [H, S_q, S_k] summed over B."""
    check_no_grad(q, k, v, bias, m, l, delta, do)
    tensors = dict(q=q, k=k, v=v, bias=bias, m=m, l=l, delta=delta, do=do)
    if not all(t.is_cuda for t in tensors.values()):
        raise ValueError("the flash backward kernel takes CUDA tensors only")
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
    groups = bwd_groups(B, H, S_q, q.device)
    part = (torch.empty((groups, H, S_q, S_k), device=q.device, dtype=torch.float32)
            if groups > 1 else dbias)
    err = _load("flash_bwd").flash_bwd(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[bias.dtype], D,
        q.data_ptr(), *_bhsd_strides(q),
        k.data_ptr(), *_bhsd_strides(k),
        v.data_ptr(), *_bhsd_strides(v),
        do.data_ptr(), *_bhsd_strides(do),
        bias.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *_bhsd_strides(dq),
        dk.data_ptr(), *_bhsd_strides(dk),
        dv.data_ptr(), *_bhsd_strides(dv),
        part.data_ptr(), dbias.data_ptr(),
        B, H, S_q, S_k, groups, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {err}")
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
