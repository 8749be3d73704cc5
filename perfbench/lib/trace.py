"""Spans around the program's calls, and the reduction of a profiler
trace to what the per-layer metrics read.

`Spans` is the wrapper of `chip_smoke.py` frozen here: while installed it
wraps each (owner, attribute) in a `record_function` span of its name and
times it on the host clock; `keep_args` names spans whose calls' shapes
are kept (the kernels' operand shapes for their rooflines). `reduce_trace`
is `chip_smoke.py::trace_split` generalised: the window is the outermost
span named `window`, and every span name gets the device operations that
were launched inside it (by correlation id), so a layer's device time
does not depend on what else overlaps it on the card.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Wrap (owner, attr, name) targets in spans while installed."""

    def __init__(self, targets: Iterable[Tuple[object, str, str]], keep_args: Iterable[str] = ()):
        self.targets = list(targets)
        self.keep = set(keep_args)
        self.host_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.args: Dict[str, List[tuple]] = {}

    def __enter__(self):
        from torch.profiler import record_function

        self.saved = []
        for owner, attr, name in self.targets:
            orig = getattr(owner, attr)

            def wrapped(*args, _orig=orig, _name=name, **kw):
                if _name in self.keep:
                    self.args.setdefault(_name, []).append(_shapes(args))
                self.calls[_name] = self.calls.get(_name, 0) + 1
                t0 = time.perf_counter()
                try:
                    with record_function(_name):
                        return _orig(*args, **kw)
                finally:
                    self.host_s[_name] = self.host_s.get(_name, 0.0) + time.perf_counter() - t0

            self.saved.append((owner, attr, orig))
            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.saved):
            setattr(owner, attr, orig)


def _shapes(args) -> tuple:
    out = []
    for a in args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            out.append((tuple(a.shape), str(a.dtype).replace("torch.", ""), a.element_size()))
        else:
            out.append(a if isinstance(a, (int, float, str)) else None)
    return tuple(out)


@contextlib.contextmanager
def span(name: str):
    """A span of the benchmark's own around a block (the traced window,
    the training step's data fetch)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def _merge(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kernel_name(name: str, width: int = 80) -> str:
    """A device operation's name without its argument list, cut to `width`."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:width]


class TraceSummary:
    """What one traced window holds, in seconds and counts."""

    def __init__(self, window_s, busy_s, device_ops, idle_gaps, idle_s_by_span, span_device,
                 span_launches):
        self.window_s = window_s
        self.busy_s = busy_s
        self.device_ops = device_ops  # [(name, seconds)] largest first
        self.idle_gaps = idle_gaps  # [(innermost span at the gap's middle, seconds)]
        self.idle_s_by_span = idle_s_by_span  # {span: idle seconds whose middle lies in it}
        self.span_device = span_device  # {span: {"all": s, "minus:<other>": s}}
        self.span_launches = span_launches  # {span: device operations launched inside}


def reduce_trace(events: List[dict], span_names: Iterable[str],
                 exclude: Optional[Dict[str, str]] = None) -> TraceSummary:
    """Reduce a Chrome trace's events. `exclude` maps a span to another
    span whose launches are taken out of its device time (a layer's own
    time without a nested one's)."""
    names = set(span_names)
    notes = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    windows = [e for e in notes if e["name"] == "window"]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    t0 = min(e["ts"] for e in windows)
    t1 = max(e["ts"] + e["dur"] for e in windows)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
           and t0 <= e["ts"] <= t1]
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        n = kernel_name(e["name"])
        by_name[n] = by_name.get(n, 0.0) + e["dur"] / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])

    spans = [e for e in notes if e["name"] in names and t0 <= e["ts"] <= t1]
    # the innermost span between consecutive span edges (spans nest)
    marks = sorted([(e["ts"], 1, i) for i, e in enumerate(spans)]
                   + [(e["ts"] + e["dur"], 0, i) for i, e in enumerate(spans)])
    edge_t, edge_name, active = [], [], []
    for t, opens, i in marks:
        if opens:
            active.append(i)
        elif i in active:
            active.remove(i)
        edge_t.append(t)
        edge_name.append(spans[active[-1]]["name"] if active else "none")

    def inner_at(t):
        k = bisect.bisect_right(edge_t, t) - 1
        return edge_name[k] if k >= 0 else "none"

    # every span open at time t (for the idle shares of enclosing spans)
    intervals = {n: _merge([(e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == n])
                 for n in names}
    starts = {n: [s for s, _ in iv] for n, iv in intervals.items()}

    def open_at(t):
        out = []
        for n, iv in intervals.items():
            k = bisect.bisect_right(starts[n], t) - 1
            if k >= 0 and iv[k][0] <= t <= iv[k][1]:
                out.append(n)
        return out

    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    idle_by_span: Dict[str, float] = {}
    idle_inner: Dict[str, float] = {}
    for g, s in gaps:
        mid = s + g / 2
        for n in open_at(mid):
            idle_by_span[n] = idle_by_span.get(n, 0.0) + g / 1e6
        n = inner_at(mid)
        idle_inner[n] = idle_inner.get(n, 0.0) + g / 1e6
    idle_gaps = sorted(idle_inner.items(), key=lambda kv: -kv[1])

    # device operations launched inside each span, by correlation id
    launches: Dict[int, List[Tuple[float, int]]] = {}
    for a in events:
        if a.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in a.get("name", ""):
            launches.setdefault(a["tid"], []).append((a["ts"], a.get("args", {}).get("correlation")))
    for v in launches.values():
        v.sort(key=lambda x: x[0])
    launch_ts = {tid: [x[0] for x in v] for tid, v in launches.items()}
    by_corr = {e.get("args", {}).get("correlation"): e for e in dev}

    def corr_in(name):
        corr = set()
        for r in spans:
            if r["name"] != name:
                continue
            ts, v = launch_ts.get(r["tid"], []), launches.get(r["tid"], [])
            lo, hi = bisect.bisect_left(ts, r["ts"]), bisect.bisect_right(ts, r["ts"] + r["dur"])
            corr |= {c for _, c in v[lo:hi] if c in by_corr}
        return corr

    span_device, span_launches = {}, {}
    corr_of = {n: corr_in(n) for n in names}
    for n in names:
        c = corr_of[n]
        d = {"all": sum(by_corr[x]["dur"] for x in c) / 1e6}
        for other in (exclude or {}).get(n, "").split(","):
            if other:
                d["minus:" + other] = sum(by_corr[x]["dur"] for x in c - corr_of[other]) / 1e6
        span_device[n] = d
        span_launches[n] = len(c)
    return TraceSummary(window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6, device_ops=device_ops,
                        idle_gaps=idle_gaps, idle_s_by_span=idle_by_span,
                        span_device=span_device, span_launches=span_launches)
