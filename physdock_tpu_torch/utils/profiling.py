"""Profiling and phase-timing utilities.

`PhaseTimer` times named host phases; `device_trace` records a
`torch.profiler` trace (host and, on the card, device activity) and
writes it as a Chrome trace; `block_and_time` gives a callable's median
time, with CUDA events when it returns tensors on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates wall-time per named phase; print with summary()."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:>24}: {total:8.3f}s total, {total / n:7.3f}s/call x{n}")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record a `torch.profiler` trace of the block (CPU activity, and CUDA
    activity where a card is present) and write it to
    `log_dir/trace.json` (Chrome trace format: chrome://tracing,
    Perfetto). Yields the profiler, for `key_averages()`; a no-op that
    yields None when log_dir is empty."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _on_card(tree) -> bool:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(t) for t in tree)
    return False


def block_and_time(fn, *args, iters: int = 3, warmup: int = 1):
    """Median time in seconds of `fn(*args)` over `iters` calls after
    `warmup` calls: CUDA events around each call when it returns tensors
    on the card, `time.perf_counter` otherwise."""
    import torch

    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    card = _on_card(out)
    times = []
    for _ in range(iters):
        if card:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
