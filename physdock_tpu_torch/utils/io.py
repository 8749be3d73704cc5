"""Host-side IO utilities: gz-pickle/json, md5 cache keys, process pools.

Equivalent of reference PhysDock/utils/io_utils.py (the md5 keying is the
cache identity contract for MSA features; io_utils.py:218-220).
"""

from __future__ import annotations

import gzip
import hashlib
import json
import multiprocessing as mp
import os
import pickle
from typing import Any, Callable, Iterable, List, Optional, Sequence


def load_pkl(path: str) -> Any:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return pickle.load(f)


def dump_pkl(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def dump_json(obj: Any, path: str, indent: int = 2) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def load_txt(path: str) -> List[str]:
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def dump_txt(lines: Iterable[str], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def md5_string(s: str) -> str:
    """md5 hex digest; the MSA feature cache key is
    md5("protein:" + sequence) (reference: io_utils.py:218, feature_loader.py:183)."""
    return hashlib.md5(s.encode()).hexdigest()


def protein_msa_key(sequence: str) -> str:
    return md5_string("protein:" + sequence)


def find_files(root: str, suffix: str = "") -> List[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(suffix):
                out.append(os.path.join(dirpath, n))
    return sorted(out)


def chunk_list(items: Sequence, n_chunks: int) -> List[List]:
    """Split into n_chunks near-equal chunks (io_utils.py list chunking)."""
    n_chunks = max(1, min(n_chunks, len(items)))
    size, rem = divmod(len(items), n_chunks)
    chunks, start = [], 0
    for i in range(n_chunks):
        extra = 1 if i < rem else 0
        chunks.append(list(items[start : start + size + extra]))
        start += size + extra
    return chunks


def run_pool_tasks(
    fn: Callable,
    tasks: Sequence,
    num_workers: Optional[int] = None,
    progress: bool = False,
) -> List:
    """Run fn over tasks with a process pool (io_utils.py:116-217).

    Falls back to serial execution for 0/1 workers or tiny task lists.
    """
    num_workers = num_workers or os.cpu_count() or 1
    if num_workers <= 1 or len(tasks) <= 1:
        it = tasks
        if progress:
            try:
                from tqdm import tqdm

                it = tqdm(tasks)
            except ImportError:
                pass
        return [fn(t) for t in it]
    ctx = mp.get_context("spawn")
    with ctx.Pool(num_workers) as pool:
        if progress:
            try:
                from tqdm import tqdm

                return list(tqdm(pool.imap(fn, tasks), total=len(tasks)))
            except ImportError:
                pass
        return pool.map(fn, tasks)
