#!/usr/bin/env python3
"""Time versions of the port's forward attention source against each other
on one CUDA card, in one process.

    python3 scripts/torch_fwd_ab.py NAME=path/to/flash_fwd.cu [NAME=...]

Each source is built with the port's nvcc flags into build/ab/lib<NAME>.so
(beside copies of the headers of csrc/, which it may include), and prints
its -Xptxas register counts. Then, at each forward call site of `chip_smoke.py`
(rows 1-4 at the main dock's shapes, the Pairformer single attention and
the MSA columns), fp32 and bf16, every version runs in turn (v1, v2, ...,
v2, v1) through `_flash_lib.launch`: its time as CUDA-graph replays, its
max abs error against the plain version, whether its output equals the
first version's bit for bit, and the time of the SIMT kernel (the stats
path) of the version built from csrc/.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SITES = {
    "row1": dict(layout="folded", B=20, H=4, S=2048, D=32),
    "row2": dict(layout="split", B=20, H=16, S=256, D=32),
    "row3": dict(layout="folded", B=256, H=4, S=256, D=32),
    "row4": dict(layout="single", B=1, H=4, S=2048, D=32),
    "pair_single": dict(layout="heads_single", B=1, H=16, S=256, D=32),
    "msa_col": dict(layout="heads", B=256, H=8, S=2, D=32, bias=False),
}


def build(versions):
    from physdock_tpu_torch.ops import _flash_lib

    out_dir = os.path.join(REPO, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(REPO, "physdock_tpu_torch", "csrc", "*.cuh")):
        shutil.copy(header, out_dir)
    procs = {}
    for name, src in versions.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        shutil.copy(src, cu)
        procs[name] = subprocess.Popen(
            [_flash_lib._nvcc(), *_flash_lib.NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {versions[name]}:\n{out}")
        regs = [line.split("Used")[1].split(",")[0].strip() for line in out.splitlines() if "Used" in line]
        print(f"[build] {name}: {regs}", flush=True)
    return {name: os.path.join(out_dir, f"lib{name}.so") for name in versions}


def main():
    import torch

    import chip_smoke as cs
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.ops.flash_attention_folded import split_view

    if not torch.cuda.is_available():
        sys.exit("torch_fwd_ab: needs a CUDA card")
    versions = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not versions:
        sys.exit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {cs.card_line()}", flush=True)
    libs = build(versions)
    _flash_lib.build_all()
    simt = _flash_lib._load("flash_fwd")
    order = list(versions) + list(versions)[::-1]
    for site, spec in SITES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = cs.make_inputs(torch, spec, dtype, 3)
            H, D = spec["H"], spec["D"]
            if spec["layout"] == "folded":
                q, k, v = (split_view(x, H) for x in (q, k, v))
            q, k, v = (x.reshape(-1, H, x.shape[-2], D) for x in (q, k, v))
            lead = 0 if bias is None else H
            ref = _flash_lib.sdpa_plain(q, k, v, bias).float()
            reps = 20 if spec["S"] >= 2048 else 50
            ms, err, same, first = {n: [] for n in versions}, {}, {}, None
            for name in order:
                _flash_lib._libs.pop("flash_fwd", None)
                _flash_lib.build = lambda *_a, _p=libs[name], **_k: _p  # noqa: E731
                run = lambda: _flash_lib.launch(q, k, v, bias, lead)  # noqa: E731
                out = run()
                first = out if first is None else first
                err[name] = float((out.float() - ref).abs().max())
                same[name] = bool(torch.equal(out, first))
                ms[name].append(cs.time_graph_ms(torch, run, reps))
            _flash_lib._libs["flash_fwd"] = simt
            simt_ms = cs.time_graph_ms(
                torch, lambda: _flash_lib.launch(q, k, v, bias, lead, stats=True), reps)
            print(f"{site} {str(dtype).replace('torch.', '')} ms {json.dumps(ms)} "
                  f"max_abs_err {json.dumps(err)} bitwise_equal_to_first {json.dumps(same)} "
                  f"simt_ms {simt_ms}", flush=True)


if __name__ == "__main__":
    main()
