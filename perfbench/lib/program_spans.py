"""The program's own spans in a traced window, and the host-device
synchronisations inside them.

The port marks its layers with spans of its own
(`physdock_tpu_torch/utils/profiling.py::span`, every name starting with
`physdock.`): user annotations in the same profiler trace as the
benchmark's spans (`perfbench/lib/trace.py`), whose names never start
so. `summarize` reduces a window's trace once more, over the benchmark's
span names and every program span the trace holds, so each idle gap is
named by the innermost span of either kind open at its middle, and
counts the synchronisations that start inside each program span.
`physdock.train.batch` is left out of the reduction: it runs on the
trainer's prefetch thread, launches nothing, and would mask the
launching thread's spans at the same instant; its host time is kept.

A synchronisation is a CUDA runtime call named cudaStreamSynchronize,
cudaDeviceSynchronize or cudaEventSynchronize, or a synchronous
cudaMemcpy, counted on any thread (the backward's calls come from the
autograd engine's thread). `.item()`, `float()` and `.cpu()` of a card
tensor, and a copy of a host tensor to the card, each show as a
cudaMemcpyAsync followed by a cudaStreamSynchronize.

`READINGS` maps each per-layer number these spans give to a function of
a traced run's `Result.layer` that holds `summarize`'s output under
"program" and the driver's step count under "steps"; each gives None
where the trace holds no program span to read (a program without them).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List

from perfbench.lib.trace import _merge, reduce_trace

PREFIX = "physdock."
OFF_THREAD = ("physdock.train.batch",)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
# idle gaps put down to no phase of the program: the benchmark's window
# and job, or no span at all
UNNAMED = ("window", "job", "none")


def _window(events) -> tuple:
    w = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
         and e["name"] == "window"]
    return min(e["ts"] for e in w), max(e["ts"] + e["dur"] for e in w)


def _program(events, t0, t1) -> List[dict]:
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e["name"].startswith(PREFIX) and t0 <= e["ts"] <= t1]


def count_syncs(events, names: Iterable[str]) -> Dict[str, int]:
    """Synchronisations whose start lies inside a span of each name, on
    any thread, in the window."""
    t0, t1 = _window(events)
    spans = _program(events, t0, t1)
    syncs = sorted(e["ts"] for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") in SYNC_CALLS
                   and t0 <= e["ts"] <= t1)
    out = {}
    for n in names:
        count = 0
        for s, e in _merge([(x["ts"], x["ts"] + x["dur"]) for x in spans if x["name"] == n]):
            count += bisect.bisect_right(syncs, e) - bisect.bisect_left(syncs, s)
        out[n] = count
    return out


def summarize(events, bench_spans: Iterable[str]) -> Dict:
    """The window reduced over the benchmark's and the program's span
    names (`trace`: a `TraceSummary`), the program's span names found
    (`names`), the synchronisations inside each (`syncs`) and each one's
    host seconds, its spans' lengths summed (`host_s`)."""
    t0, t1 = _window(events)
    spans = _program(events, t0, t1)
    found = {e["name"] for e in spans}
    names = sorted(found - set(OFF_THREAD))
    host_s: Dict[str, float] = {}
    for e in spans:
        host_s[e["name"]] = host_s.get(e["name"], 0.0) + e["dur"] / 1e6
    return {"trace": reduce_trace(events, set(bench_spans) | set(names)), "names": names,
            "syncs": count_syncs(events, names), "host_s": host_s}


def unnamed_share(summary) -> float:
    """The share of the window's idle time whose innermost span is the
    benchmark's window or job, or none: what no phase of the program
    accounts for."""
    gaps = dict(summary["trace"].idle_gaps)
    idle = sum(gaps.values())
    return sum(gaps.get(n, 0.0) for n in UNNAMED) / idle if idle else 0.0


def _idle_ms(run, names) -> float:
    """Milliseconds the card sat idle inside any of `names`, per step."""
    prog = (run or {}).get("program")
    if not prog or not run["steps"] or not set(names) <= set(prog["names"]):
        return None
    idle = prog["trace"].idle_s_by_span
    return sum(idle.get(n, 0.0) for n in names) * 1e3 / run["steps"]


def _syncs(run, name) -> float:
    """Synchronisations inside `name`, per step."""
    prog = (run or {}).get("program")
    if not prog or not run["steps"] or name not in prog["names"]:
        return None
    return prog["syncs"][name] / run["steps"]


READINGS = {
    # card idle gaps whose middle lies inside the train step's forward
    # (the loss included), backward, and clip and update, per step
    "autograd.forward_idle_ms.train": lambda run: _idle_ms(run, ["physdock.train.forward"]),
    "autograd.backward_idle_ms.train": lambda run: _idle_ms(run, ["physdock.train.backward"]),
    "autograd.update_idle_ms.train":
        lambda run: _idle_ms(run, ["physdock.train.clip", "physdock.train.update"]),
    "autograd.syncs_per_step.train": lambda run: _syncs(run, "physdock.train.step"),
    # a reverse step's idle gaps, the denoiser, guidance and update
    # included (what a captured step would remove), per reverse step
    "sampler.step_idle_ms.redock": lambda run: _idle_ms(run, ["physdock.sampler.step"]),
    "sampler.syncs_per_step.redock": lambda run: _syncs(run, "physdock.sampler.step"),
}
