"""Build, load and launch the hand-written Hopper attention kernel.

`csrc/flash_fwd.cu` is compiled with `nvcc` into `build/libflash_fwd.so`
at the repo root the first time a wrapper launches it (plain C interface,
bound with ctypes; no PyTorch headers, so the build takes seconds).  Every
wrapper in `ops/flash_attention*.py` goes through `launch`, which checks
what the kernel takes and raises on anything else.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flash_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libflash_fwd.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
# kernel launches per wrapper; a wrapper adds one only where it launches
LAUNCHES = {
    "flash_sdpa": 0,
    "flash_sdpa_grouped": 0,
    "flash_sdpa_folded": 0,
    "flash_sdpa_folded_v3": 0,
}
BUILD_LOG = {"seconds": None, "ptxas": ""}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or older than its
    source. Returns the library path; the compiler's `-Xptxas -v` report
    (registers, shared memory, spills) lands in BUILD_LOG."""
    if (
        not force
        and os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)
    ):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + f".tmp{os.getpid()}"
    t0 = time.time()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    BUILD_LOG["seconds"] = time.time() - t0
    BUILD_LOG["ptxas"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.flash_fwd.argtypes = (
            [i32, i32, i32]
            + [p, i64, i64, i64] * 4
            + [p, i64, i64, i32]
            + [i32, i32, i32, i32, ctypes.c_float, p]
        )
        lib.flash_fwd.restype = i32
        _lib = lib
    return _lib


def _bhsd_strides(x: torch.Tensor):
    return x.stride(0), x.stride(1), x.stride(2)


def launch(q, k, v, bias, lead: int) -> torch.Tensor:
    """Launch the kernel on [B, H, S, D] views of q/k/v (any strides with a
    contiguous D axis). `bias` is None or a contiguous [lead, S_q, S_k]
    tensor whose row-block `(b*H + h) % lead` serves (b, h). Returns a new
    [B, H, S_q, D] tensor, stored folded ([B, S, H, D] memory) when q is."""
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
    lib = _load()
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], b_code, D,
        q.data_ptr(), *_bhsd_strides(q),
        k.data_ptr(), *_bhsd_strides(k),
        v.data_ptr(), *_bhsd_strides(v),
        o.data_ptr(), *_bhsd_strides(o),
        *b_args,
        B, H, S_q, S_k, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    return o


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
