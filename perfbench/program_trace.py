"""One traced run of a benchmark cell, read by the program's own spans as
well (`perfbench/lib/program_spans.py`):

    python3 perfbench/program_trace.py --workload CELL --seed N [--seconds S]

The run is `perfbench/run.py --trace 1`'s: the same driver, profiler,
spans and window. The trace the driver reduces is also reduced over the
program's spans, and one JSON line is printed: the traced window's
end-to-end rate (which `run.py` leaves out of a traced line), the
per-layer metrics `BENCHMARK.json` gives the cell, the readings of
`program_spans.READINGS`, the share of the idle time that no program span
accounts for, the idle gaps by innermost span of either kind, and each
program span's idle seconds, synchronisations and host seconds. The
benchmark's runs never run it; `--seconds` defaults to `run_seconds`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def traced(cell, seed: int, seconds: float, device: str = "cuda", overrides=None) -> dict:
    """One traced run of `cell` (a `harness.Cell`), read by the program's
    spans too: the printed line's object."""
    from perfbench.lib import harness, program_spans, trace

    ctx = harness.Context(cell, seed, seconds, True, device, harness.process_start(),
                          overrides)
    kept = {}
    reduce = trace.reduce_trace

    def reduce_and_keep(events, span_names, exclude=None):
        kept.setdefault("program", program_spans.summarize(events, span_names))
        return reduce(events, span_names, exclude)

    trace.reduce_trace = reduce_and_keep
    driver = harness.load_module(
        os.path.join(cell.root, "perfbench", "drivers", cell.traffic["driver"] + ".py"),
        "perfbench_driver_" + cell.traffic["driver"])
    try:
        res = driver.run(ctx)
    finally:
        trace.reduce_trace = reduce
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    layer = dict(res.layer, **kept)
    per_layer = {}
    for name in cell.layer:
        reader = harness.load_module(os.path.join(cell.root, "perfbench", "metrics", name + ".py"),
                                     "perfbench_metric_" + name.replace(".", "_"))
        per_layer[name] = reader.read(layer)
    prog = layer["program"]
    summ = prog["trace"]
    return {
        "workload": cell.name, "seed": seed, "device": harness.device_kind(device),
        "traced_e2e": res.e2e, "attempted": res.attempted, "failed": res.failed,
        "checks": {k: list(v) for k, v in res.checks.items()},
        "window_s": summ.window_s, "busy_s": summ.busy_s, "steps": layer["steps"],
        "per_layer": per_layer,
        "program": {name: fn(layer) for name, fn in program_spans.READINGS.items()},
        "unnamed_idle_share": program_spans.unnamed_share(prog),
        "idle_gaps": summ.idle_gaps,
        "idle_s_by_program_span": {n: summ.idle_s_by_span.get(n, 0.0) for n in prog["names"]},
        "syncs": prog["syncs"], "host_s": prog["host_s"],
    }


def main(argv=None) -> int:
    from perfbench.lib import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    seconds = args.seconds or harness.load_json(
        os.path.join(cell.root, "BENCHMARK.json"))["run_seconds"]
    harness.set_environment()
    print(json.dumps(traced(cell, args.seed, seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
