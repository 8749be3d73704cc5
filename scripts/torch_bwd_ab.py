#!/usr/bin/env python3
"""Time versions of the port's backward attention source against each other
on one CUDA card, in one process.

    python3 scripts/torch_bwd_ab.py NAME=path/to/flash_bwd.cu[@BLOCKS] [NAME=...]

Each source is built with the port's nvcc flags into build/ab/lib<NAME>.so
(beside copies of the headers of csrc/), and prints its -Xptxas register
counts. `@BLOCKS` chooses the dq/dbias kernel's batch groups as if BLOCKS
blocks fit one SM (default: the kernel's occupancy, as committed).
Then, at the two training call sites of rows 5-6 (`chip_smoke.py`
TRAIN_SHAPES), fp32 and bf16, every version runs in turn (v1, v2, ...,
v2, v1) through `_flash_lib.launch_bwd` on the forward's m and l: its time
as CUDA-graph replays, its max error relative to max|plain| over dq, dk,
dv and dbias, and, from one profiled call, the device time of each kernel
it launched.
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


def build(versions):
    from physdock_tpu_torch.ops import _flash_lib

    out_dir = os.path.join(REPO, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(REPO, "physdock_tpu_torch", "csrc", "*.cuh")):
        shutil.copy(header, out_dir)
    procs = {}
    for name, (src, _) in versions.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        shutil.copy(src, cu)
        procs[name] = subprocess.Popen(
            [_flash_lib._nvcc(), *_flash_lib.NVCC_FLAGS, "-o", os.path.join(out_dir, f"lib{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {versions[name][0]}:\n{out}")
        lines = out.splitlines()
        regs = [(lines[i - 2].split("_tc")[-1][:24], line.split("Used")[1].split(",")[0].strip(),
                 lines[i - 1].strip())
                for i, line in enumerate(lines) if "Used" in line and i >= 2 and "_tc" in lines[i - 2]]
        print(f"[build] {name}: {regs}", flush=True)
    return {name: os.path.join(out_dir, f"lib{name}.so") for name in versions}


def kernel_times(torch, fn):
    """{kernel name: device ms} of one call of fn, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t > 0:
            out[ev.key[:60]] = round(t / 1e3, 4)
    return out


def main():
    import torch

    import chip_smoke as cs
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.ops.flash_attention_bwd import flash_bwd_plain, flash_fwd_lse
    from physdock_tpu_torch.ops.flash_attention_folded import split_view

    if not torch.cuda.is_available():
        sys.exit("torch_bwd_ab: needs a CUDA card")
    versions = {}
    for arg in sys.argv[1:]:
        name, spec = arg.split("=", 1)
        src, _, blocks = spec.partition("@")
        versions[name] = (src, int(blocks) if blocks else None)
    if not versions:
        sys.exit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {cs.card_line()}", flush=True)
    libs = build(versions)
    order = list(versions) + list(versions)[::-1]
    dq_slots = _flash_lib.dq_slots
    for site, spec in cs.TRAIN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            B, H, S, D = spec["B"], spec["H"], spec["S"], spec["D"]
            q, k, v, bias = cs.make_inputs(torch, spec, dtype, seed=S + B)
            q, k, v = (split_view(x, H) for x in (q, k, v))
            g = torch.Generator(device="cuda").manual_seed(B)
            do = split_view(torch.randn((B, S, H * D), generator=g, device="cuda").to(dtype), H)
            o, m, l = flash_fwd_lse(q, k, v, bias)
            delta = torch.sum(do.float() * o.float(), dim=-1)
            ref = flash_bwd_plain(q, k, v, bias, o, m, l, do)
            reps = 3 if S >= 2048 else 10
            ms, err, prof = {n: [] for n in versions}, {}, {}
            for name in order:
                _flash_lib._libs.pop("flash_bwd", None)
                _flash_lib.build = lambda *_a, _p=libs[name], **_k: _p  # noqa: E731
                _flash_lib._DQ_BLOCKS.clear()
                blocks = versions[name][1]
                _flash_lib.dq_slots = dq_slots if blocks is None else (
                    lambda *a, _n=blocks: _n * _flash_lib._sm_count(a[-1]))
                run = lambda: _flash_lib.launch_bwd(q, k, v, bias, m, l, delta, do)  # noqa: E731
                out = run()
                torch.cuda.synchronize()
                err[name] = max(float((x.float() - r.float()).abs().max() / r.float().abs().max())
                                for x, r in zip(out, ref))
                del out
                ms[name].append(cs.time_graph_ms(torch, run, reps))
                if name not in prof:
                    prof[name] = kernel_times(torch, run)
            print(f"{site} {str(dtype).replace('torch.', '')} ms {json.dumps(ms)} "
                  f"max_rel_err {json.dumps(err)} kernels {json.dumps(prof)}", flush=True)
            del ref, o, m, l, delta
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
