"""ctypes bindings for the native host library (`csrc/physdock_native.cpp`).

The library is built with g++ at first use into the compile cache
(`build/` by default, `utils/compile_cache.py`): one compile to a file
of this process's own, then an atomic rename, so processes that start
together never load a half-written library. A failed build raises with
g++'s output. The NumPy versions (`*_np`) compute the same functions and
are the plain references the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.utils.compile_cache import env_build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "physdock_native.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
BUILD_DIR = env_build_dir()
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib_path() -> str:
    return os.path.join(BUILD_DIR, "libphysdock_native.so")


def build(force: bool = False) -> str:
    """Compile the library if it is missing or older than its source."""
    path = lib_path()
    if not force and os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(SOURCE):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
            i8p, i32p = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32)
            lib.a3m_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
            lib.a3m_parse.argtypes = [ctypes.c_char_p, i64, i64, i8p, i8p]
            lib.pairwise_rmsd.argtypes = [f32p, i64, i64, f32p]
            lib.conformer_dist_bank.argtypes = [f32p, i64, i64, f32p]
            lib.perceive_bonds.argtypes = [f32p, i32p, i64, ctypes.c_float, i32p, i64]
            lib.perceive_bonds.restype = i64
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a probe: the functions
    below raise instead)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_a3m_int8(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """A3M text -> (msa int8 [N, L], deletions int8 [N, L])."""
    lib = _load()
    raw = text.encode()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    lib.a3m_dims(raw, ctypes.byref(rows), ctypes.byref(cols))
    msa = np.empty((rows.value, cols.value), np.int8)
    dele = np.empty((rows.value, cols.value), np.int8)
    lib.a3m_parse(raw, rows.value, cols.value, _ptr(msa, ctypes.c_int8), _ptr(dele, ctypes.c_int8))
    return msa, dele


def pairwise_rmsd(poses: np.ndarray) -> np.ndarray:
    """[S, L, 3] -> [S, S] RMSD matrix (float64 sums)."""
    poses = np.ascontiguousarray(poses, np.float32)
    s, n, _ = poses.shape
    out = np.empty((s, s), np.float32)
    _load().pairwise_rmsd(_ptr(poses, ctypes.c_float), s, n, _ptr(out, ctypes.c_float))
    return out


def conformer_dist_bank(confs: np.ndarray) -> np.ndarray:
    """[C, L, 3] -> [C, L, L] distance matrices."""
    confs = np.ascontiguousarray(confs, np.float32)
    c, n, _ = confs.shape
    out = np.empty((c, n, n), np.float32)
    _load().conformer_dist_bank(_ptr(confs, ctypes.c_float), c, n, _ptr(out, ctypes.c_float))
    return out


def perceive_bonds(pos: np.ndarray, atomic_numbers: np.ndarray,
                   scale: float = 1.3) -> List[Tuple[int, int]]:
    """Distance-based covalent bond perception: pairs (i < j, in order) with
    0.5 A < d < scale * (r_cov_i + r_cov_j), at most 8 per atom."""
    pos = np.ascontiguousarray(pos, np.float32)
    z = np.ascontiguousarray(atomic_numbers, np.int32)
    n = len(z)
    max_bonds = n * 8
    buf = np.empty((max_bonds, 2), np.int32)
    count = _load().perceive_bonds(_ptr(pos, ctypes.c_float), _ptr(z, ctypes.c_int32), n,
                                   ctypes.c_float(scale), _ptr(buf, ctypes.c_int32), max_bonds)
    return [tuple(map(int, b)) for b in buf[:count]]


# --------------------------------------------------------------------------
# The plain NumPy versions (the JAX package's fallbacks), for the tests
# --------------------------------------------------------------------------


def parse_a3m_int8_np(text: str) -> Tuple[np.ndarray, np.ndarray]:
    from physdock_tpu_torch.data.msa.parsers import parse_a3m
    from physdock_tpu_torch.data.msa.search import msa_to_int8

    f = msa_to_int8(parse_a3m(text))
    return f["msa"], f["deletion_matrix"]


def pairwise_rmsd_np(poses: np.ndarray) -> np.ndarray:
    poses = np.ascontiguousarray(poses, np.float32)
    diff = poses[:, None] - poses[None]
    return np.sqrt(np.mean(np.sum(diff**2, -1), -1)).astype(np.float32)


def conformer_dist_bank_np(confs: np.ndarray) -> np.ndarray:
    confs = np.ascontiguousarray(confs, np.float32)
    return np.linalg.norm(confs[:, :, None] - confs[:, None], axis=-1).astype(np.float32)


def perceive_bonds_np(pos: np.ndarray, atomic_numbers: np.ndarray,
                      scale: float = 1.3) -> List[Tuple[int, int]]:
    from physdock_tpu_torch.data.embed import _COV_RADII

    pos = np.asarray(pos, np.float32)
    z = np.asarray(atomic_numbers, np.int32)
    n = len(z)
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            d = np.linalg.norm(pos[i] - pos[j])
            rmax = scale * (_COV_RADII.get(int(z[i]), 1.2) + _COV_RADII.get(int(z[j]), 1.2))
            if 0.5 < d < rmax:
                out.append((i, j))
    return out
