#!/usr/bin/env python3
"""The main dock of `chip_smoke.py` (5SAK_ZRY_A_1 at crop 256/2048, 2 rounds
of 20 poses, fp32) in the checkout it is run from, on one CUDA card: one
warm-up dock, then RUNS timed ones (default 2), each printing its wall
time, poses/s, the result's timings and top-ranked RMSD, and the kernel
launches.

    cd <checkout> && python3 <this repo>/scripts/torch_dock_ab.py [RUNS]

To compare two commits on one card, unpack the parent into a directory
that .gitignore lists and run this from both checkouts in turn, in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time


def main():
    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from physdock_tpu_torch.ops import _flash_lib

    if not torch.cuda.is_available():
        sys.exit("torch_dock_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    _flash_lib.build_all()
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="dock_ab_", dir=os.path.join(root, "build"))
    cs.phase_main(os.path.join(work, "warm"))
    for i in range(runs):
        torch.cuda.synchronize()
        _flash_lib.reset_launches()
        t0 = time.time()
        res = cs.phase_main(os.path.join(work, f"run{i}"))[0]
        torch.cuda.synchronize()
        wall = time.time() - t0
        print(f"[dock_ab] {root} run {i}: wall {wall:.3f} s, {20 * res['rounds'] / wall:.3f} poses/s, "
              f"timings {json.dumps(res['timings'])}, total {res['total_time_s']} s, "
              f"top {res['top5_rmsd'][0]:.4f} A, launches {json.dumps(dict(_flash_lib.LAUNCHES))} "
              f"({cs.card_line()})", flush=True)


if __name__ == "__main__":
    main()
