"""Training metrics logging (port of `physdock_tpu/train/metrics.py`).

The reference logs scalars through Uni-Core's TensorBoard hook
(tasks/unicore_train/__init__.py:177-190).  Here: a dependency-free JSONL
scalar log (one `{"step", "time", <scalars>}` line per call, flushed every
`flush_every` lines), plus a TensorBoard export through
`torch.utils.tensorboard` when it can be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, flush_every: int = 20):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a")
        self._n = 0
        self.flush_every = flush_every
        self._tb = None
        try:  # optional TensorBoard writer (needs the tensorboard package)
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._f.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
