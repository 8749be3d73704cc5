"""The port's tracing: `span` marks a layer of the program in a
`torch.profiler` trace, and `device_trace` records such a trace of a
block and writes it as a Chrome trace.

A span is a `record_function` user annotation, on the profiler's clock
beside the card's kernels, copies and CUDA runtime calls. Spans nest, a
child wholly inside its parent, so a layer's self time is its span less
its children's. Every name starts with `physdock.`. Tracing is on exactly
while a profiler session runs in the process: with none, a span checks
one flag and does nothing else. Spans are host-only and do not disturb
CUDA graph capture.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
from typing import Optional


def _profiling() -> bool:
    """Whether a profiler session runs in this process: torch's own
    process-wide flag, which holds on every thread (the C++ profiler's
    thread-local state does not reach threads that it did not start). A
    process that has not imported torch (the featurizer worker) runs
    none."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class span:
    """`with span("physdock.layer"):` or `@span("physdock.layer")`: a
    `record_function` of that name while a profiler session runs, else
    nothing."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kw):
            with span(name):
                return fn(*args, **kw)

        return spanned


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record a `torch.profiler` trace of the block (CPU activity of every
    thread, and CUDA activity where a card is present), the program's
    spans in it, and write it to `log_dir/trace.json` (Chrome trace
    format: chrome://tracing, Perfetto). Yields the profiler, for
    `key_averages()`; a no-op that yields None when log_dir is empty."""
    if not log_dir:
        yield None
        return
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # the trainer's batches are assembled on a prefetch thread
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
