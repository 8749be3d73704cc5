"""Spreads of repeated runs and the bounds they give.

    python3 perfbench/lib/bounds.py SET_A.jsonl SET_B.jsonl [...]

Each file holds the result lines of one set of runs of one cell (the last
line of each run's standard output). For every metric it prints each
set's median and spread, the spread being the distance between the first
and third quartiles (`statistics.quantiles(values, n=4)`) over the
median; the wider spread; five times it, never under 1% (the bound to
set), and the two readings a check takes of a bound: the mean of the
sets' spreads with each set's run farthest from its median left out
(a bound under twice it is too tight), and the spread of all runs
together (a bound over eight times it is too loose).
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values: List[float]) -> float:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def read_set(path: str) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            for name, m in json.loads(line)["metrics"].items():
                out.setdefault(name, []).append(float(m["value"]))
    return out


def summary(sets: List[Dict[str, List[float]]]) -> Dict[str, Dict]:
    rows = {}
    for name in sets[0]:
        vals = [s[name] for s in sets if len(s.get(name, [])) >= 3]
        if not vals:
            continue
        spreads = [spread(v) for v in vals]
        widest = max(spreads)
        rows[name] = {
            "medians": [statistics.median(v) for v in vals],
            "spreads": spreads,
            "widest": widest,
            "bound": min(0.25, max(0.01, 5 * widest)),
            "tight_reading": statistics.mean(trimmed_spread(v) for v in vals),
            "loose_reading": spread([x for v in vals for x in v]),
            "second_median_change": (statistics.median(vals[-1]) / statistics.median(vals[0])
                                     - 1.0) if len(vals) > 1 else None,
        }
    return rows


if __name__ == "__main__":
    print(json.dumps(summary([read_set(p) for p in sys.argv[1:]]), indent=1))
