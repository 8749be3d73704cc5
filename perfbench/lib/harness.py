"""The benchmark's entry: find the cell, prepare the environment, run the
cell's driver, read the per-layer metrics, check what the process has
loaded and print the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in `BENCHMARK.json`:

  * `perfbench/configs/<config>.json`: the model's sizes and dtype;
  * `perfbench/workloads/<traffic>.json`: the driver that serves the
    traffic (`perfbench/drivers/<driver>.py`), its parameters and the
    limits of the comparison that decides `correct`;
  * `perfbench/metrics/<metric>.py`: a reader with `read(run)`, which
    returns the metric, in the unit `BENCHMARK.json` gives it, from the
    traced run, or None where it finds nothing to read.

A driver's `run(ctx)` builds the program, warms up, calls
`ctx.open_window()` as its window starts, measures for `ctx.seconds` and
returns a `Result`. Its end-to-end metrics are host clocks; the traced
run's per-layer metrics come from the spans, counters and device trace
that the driver hands to the readers in `Result.layer`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "physdock_tpu")


def process_start() -> float:
    """This process's start on the `time.time()` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with its configuration and traffic."""

    name: str
    root: str
    chips: int
    config: Dict
    traffic: Dict
    e2e: Dict[str, str]  # end-to-end metric -> unit, setup_s left out
    layer: Dict[str, str]  # per-layer metric -> unit


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "workloads", w["traffic"] + ".json"))
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name]) and m["name"] != "setup_s"}
    layer = {m["name"]: m["unit"] for m in bench["per_layer"]
             if name in m.get("workloads", [name])}
    return Cell(name=name, root=root, chips=int(w["chips"]), config=config, traffic=traffic,
                e2e=e2e, layer=layer)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Result:
    """What a driver hands back. `e2e`: end-to-end values by metric name;
    `checks`: {name: (value, limit)} of the comparison with the reference;
    `layer`: what the metric readers read (a dict; see the drivers)."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: Dict[str, tuple]
    memory_peak_bytes: int
    layer: Optional[Dict] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict] = None


class Context:
    """A run's settings and clocks, handed to the driver."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str,
                 t_start: float, overrides: Optional[Dict] = None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.t_window: Optional[float] = None
        self.config = dict(cell.config, **(overrides or {}).get("config", {}))
        self.params = dict(cell.traffic["params"], **(overrides or {}).get("params", {}))
        self.limits = cell.traffic["limits"]
        self.tmp = tempfile.mkdtemp(prefix="perfbench_")

    def window_seconds(self) -> float:
        """The window's length: `--seconds`, or in a traced run the
        traffic's shorter `trace_seconds` where it gives one (a trace of
        the whole window would take longer to read than a run may last;
        a window still closes at the first completion after it)."""
        if self.trace and "trace_seconds" in self.params:
            return min(self.seconds, float(self.params["trace_seconds"]))
        return self.seconds

    def open_window(self) -> float:
        self.t_window = time.time()
        return self.t_window


def set_environment(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX for libraries that would load it by themselves."""
    build = os.path.join(root, "perfbench", ".build")
    os.environ["PHYSDOCK_COMPILE_CACHE"] = build
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, overrides: Optional[Dict] = None) -> Dict:
    """Run `cell` and return the result line's object (without printing)."""
    import shutil

    ctx = Context(cell, seed, seconds, trace, device, t_start or time.time(), overrides)
    driver = load_module(os.path.join(cell.root, "perfbench", "drivers",
                                      cell.traffic["driver"] + ".py"),
                         "perfbench_driver_" + cell.traffic["driver"])
    try:
        res: Result = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    if ctx.t_window is None:
        raise RuntimeError("the driver never opened its window")
    checks_ok = all(v is not None and v == v and v <= lim for v, lim in res.checks.values())
    out = {"correct": bool(checks_ok and res.failed == 0 and res.attempted > 0),
           "attempted": res.attempted, "failed": res.failed}
    metrics = {}
    if trace:
        for name, unit in cell.layer.items():
            reader = load_module(os.path.join(cell.root, "perfbench", "metrics", name + ".py"),
                                 "perfbench_metric_" + name.replace(".", "_"))
            value = reader.read(res.layer)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": unit}
    else:
        for name, unit in cell.e2e.items():
            metrics[name] = {"value": float(res.e2e[name]), "unit": unit}
        metrics["setup_s"] = {"value": ctx.t_window - ctx.t_start, "unit": "s"}
    out["metrics"] = metrics
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": device_kind(device),
           "count": cell.chips, "memory_peak_bytes": int(res.memory_peak_bytes)}
    if trace:
        dev["busy_s"], dev["window_s"] = res.busy_s, res.window_s
        if res.breakdown:
            out["breakdown"] = res.breakdown
    out["device"] = dev
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res.checks.items()}
    return out


def device_kind(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PhysDock port benchmark: one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    set_environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   process_start())
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
