"""Where the port's compiled libraries live: the CUDA kernels
(`ops/_flash_lib.py`, built with nvcc) and the native host library
(`native/`, built with g++).

Each is compiled at first use and kept, so a later process loads it
instead of compiling again (~30 s for the kernels). The directory is
`PHYSDOCK_COMPILE_CACHE`, by default `build/` at the repository root;
`0`, `off` or `none` disable the cache, as in the JAX package: each
process then builds into a temporary directory of its own, removed when
it exits. `enable()` is called by the CLIs (`cli/common.py`).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

ENV = "PHYSDOCK_COMPILE_CACHE"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
_OFF = ("0", "off", "none", "")


def env_build_dir() -> str:
    """The build directory named by the environment (the default when it
    is unset or disables the cache): the libraries' starting point."""
    d = os.environ.get(ENV, DEFAULT_DIR)
    return DEFAULT_DIR if d.lower() in _OFF else d


def enable(cache_dir: str | None = None) -> str | None:
    """Point the kernel and native builds at `cache_dir` (else
    `PHYSDOCK_COMPILE_CACHE`, else `build/`). Returns the directory in
    use, or None when the cache is disabled. Child processes (the
    featurizer worker, ranks) inherit the choice through the environment."""
    from physdock_tpu_torch import native
    from physdock_tpu_torch.ops import _flash_lib

    d = cache_dir or os.environ.get(ENV, DEFAULT_DIR)
    cached = d.lower() not in _OFF
    if cached:
        os.makedirs(d, exist_ok=True)
    else:
        d = tempfile.mkdtemp(prefix="physdock_build_")
        atexit.register(shutil.rmtree, d, True)
    _flash_lib.BUILD_DIR = native.BUILD_DIR = d
    os.environ[ENV] = d
    return d if cached else None
