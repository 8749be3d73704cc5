#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`physdock_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing its result and seconds on flushed lines; any failure
exits non-zero (no phase is caught):

  1. device   -- nvidia-smi name and power limit, torch and CUDA versions
  2. build    -- nvcc of csrc/flash_fwd.cu and csrc/flash_bwd.cu, one
                 process each, started together, with the -Xptxas -v
                 reports; then cuobjdump -sass of both libraries: every
                 instance of the tensor-core kernels (flash_fwd_tc, which
                 also serves the forward with stats, and the backward's
                 dq_dbias_tc and dkdv_tc) must hold HGMMA (wgmma) and
                 LDGSTS (cp.async)
  3. kernels  -- each of the four forward attention wrappers at its
                 call-site shape, fp32 and bf16, masked rows and the -2e9
                 tier included, against its plain PyTorch version (fp32
                 <= 1e-4 with TF32 off, bf16 <= 2e-2); kernel, plain and
                 SDPA times, and the same-call time of the SIMT kernel at
                 the same inputs (the stats path, `before_ms`), each the
                 device time of CUDA-graph replays; and row 1 at the
                 batched screen's atom-DiT site (B 80 = 20 samples x 4
                 systems sample-major, H 4, S 1920, one bias per system:
                 lead 16), and row 3 at the batched redock's (the same
                 with S 896)
  4. kernels (training) -- the kernels at the shapes and strides the
                 medium train run gives them (crop 256/2048, 48 samples):
                 flash_sdpa_grouped at the token DiT (B 48, H 16, S 256,
                 D 32) and the MSA rows (B 2, H 8), flash_sdpa at the
                 Pairformer single attention (H 16, S 256), the trunk
                 atom transformer (H 4, S 2048) and the MSA columns (no
                 bias), each against its plain version at phase 3's
                 limits (with their before_ms); flash_fwd_lse and
                 flash_bwd at their two call
                 sites (atom DiT: B 48, H 4, S 2048, D 32; triangle:
                 B 256, H 4, S 256, D 32): o, m, l, dq, dk, dv and dbias
                 against the plain versions (rel to max|plain|: fp32 1e-4,
                 bf16 2e-2); all fp32 and bf16 with masked rows and the
                 -2e9 tier; kernel, plain and SDPA times (for rows 5-6 the
                 memory-efficient SDPA forward, backward alone, the bias
                 expanded over B and requiring grad), and for rows 5-6 the
                 same-call time of the SIMT pair at the same inputs
                 (`before_ms`); kernel and SIMT times are CUDA-graph
                 replays, plain and SDPA times eager
  4b. conf kernels -- rows 3 and 4 at the confidence head's sites in the
                 confidence dock (triangle B 128, H 4, S 128; single
                 attention H 16, S 128; atoms H 4, S 832), fp32 and bf16,
                 against their plain versions at phase 3's limits, with
                 kernel, SIMT, plain and SDPA times
  4c. tp kernels -- rows 1-6 at the row-shard shapes of a tp=2 rank (this
                 rank's S/2 query rows of q and of the bias against all
                 S_k keys): the tp dock's atom DiT (row 1, S_q 1024 of
                 2048), token DiT and MSA rows (row 2), triangle ending
                 node (row 3, and a ragged shard of 100 rows of 200),
                 Pairformer single attention (row 4), and the tp train
                 step's atom DiT and triangle sites (rows 5-6, with the
                 ragged shard), fp32 and bf16, each against its plain
                 version at phase 3's and phase 4's limits, with kernel,
                 SIMT, plain and SDPA times and the bound at S_q x S_k
  5. model    -- the toy model's conditioning, DiT bias cache and denoise
                 at the main dock's shapes (256 tokens, 2048 atoms, 2
                 samples), on the card through the kernels and on the CPU
                 through their plain versions; every output within rel
                 1e-3 of max|cpu| (fp32, TF32 off), and every forward
                 wrapper, the atom DiT's v3 included, launched; then the
                 confidence head with the committed confidence weights
                 (_confidence/ema_params_conf.npz) on one pose at crop
                 256/2048 with padding (224 tokens and 1792 atoms real),
                 each device from its own trunk: p_pae, p_pde and p_plddt
                 within rel 1e-3 of max|cpu|, rows 3 and 4 launched in the
                 head
 5a. recycle  -- the toy conditioning with num_recycles=1 and non-zero
                 recycle projections (from a numpy seed; they are
                 zero-initialised) at phase 5's shapes, card against CPU:
                 s and z within rel 1e-3 of max|cpu|
  6. grad     -- one training step's loss and gradient of the toy model
                 (committed weights) on 5SAK_ZRY_A_1 featurized in training
                 mode at crop 128/1024 with 4 augmentation samples, the
                 noise drawn from the train step's keyed CPU streams
                 (`train/draws.py`): on the card through
                 the kernels and on the CPU through the plain versions;
                 loss within rel 1e-4, ||g_card - g_cpu|| <= 1e-3 ||g_cpu||
                 over all parameters; rows 5, 6, 2 and 4 launched, rows 1
                 and 3 not (the dispatch under grad), and rows 5-6 on the
                 tensor-core pair, the SIMT pair never; then the same for
                 one mini-rollout step of the model with the confidence
                 weights on the corrupt-pose route (alpha_pae 1), the
                 corruption's draws from its own keyed stream: the same
                 limits, and every confidence-head parameter with a
                 non-zero gradient on the card; then grad bf16: the plain
                 step in bf16 compute on the card against the fp32 step on
                 the card, within the JAX package's own bf16 spread as
                 tests/test_torch_train_bf16.py measures it (gradient rel
                 4.61e-2 by global norm, each loss term rel 3.68e-2), rows
                 5, 6, 2 and 4 launched, every launch in bf16, rows 5-6 on
                 the tensor-core pair
  7. accuracy -- guided redocking of the 4 demo systems with the committed
                 toy weights (_overfit/ema_params.npz) at crop 128/1024,
                 40 steps, 2 rounds, 20 poses per round, fp32, through
                 the CLI, which takes them through dock_many and the
                 featurizer worker (no "[dock_many failed" line; the
                 first system featurized in process, the worker's
                 receive timings in every later result); every
                 top-ranked ligand RMSD must be < 2 A, rows 2-4 launched,
                 and every system directory must hold a bust_report.json
                 of five entries, each with pose_valid
 7a. accuracy bf16 -- the accuracy dock with --bf16: top-1 < 2 A on 4/4,
                 each system printed beside its fp32 top-1; rows 2-4
                 launched, every launch in bf16, the SIMT route never
 7b. redock_many -- the 4 systems one after the other with
                 DockingPipeline.dock, featurized in process (what the
                 CLI does for one system), each held to its dock_many
                 result (rank order equal, pose RMSDs within 1e-4 A); then
                 --dock_batch_size 4 (counts reset before, read after:
                 rows 2-4 launched; top-1 < 2 A on 4/4; the group padded
                 to phase 3's redock site; group sizes and rounds_s
                 printed); then 5SAK_ZRY_A_1 with
                 --enable_sidechain_relaxation (top-1 < 2 A); the
                 sequential, dock_many and batched walls, and the seconds
                 per system of check_pose and relax_complex
 7c. confidence -- the same dock of the 4 systems with the committed
                 confidence weights and --enable_confidence
                 --confidence_ranking: every pose's metrics finite
                 (mean_plddt in [0, 100], ptm and iptm in [0, 1]),
                 confidence.json written, ranking_confidence
                 non-increasing along the rank order, the rank order
                 the argsort of the float32 scores, and the
                 confidence-ranked top-1 ligand RMSD < 2 A on 4/4; the
                 head's seconds per pose (timed around the pipeline's
                 `_confidence_scores`) and its launches per row
  8. main     -- one demo system at crop 256/2048 (20 poses per round):
                 launch counters reset before and read after; every
                 forward wrapper must have launched, and the top-ranked
                 RMSD must lie within 0.5 A of the CPU reading of both
                 packages
 8a. native   -- g++ of the native host library, then its four functions
                 against their NumPy versions: perceive_bonds on the 8 demo
                 SMILES embedded (scales 1.17 and 1.25; the same pairs),
                 pairwise_rmsd and conformer_dist_bank on the ligand atoms
                 of 20 of the main dock's poses (rel 1e-5 of the
                 largest value), the A3M parse of a demo MSA feature file
                 written as A3M (equal, and equal to the features); each
                 one's seconds, native and NumPy
 8b. demo     -- data/demo.make_demo_complex on the host, then the
                 redocking CLI on the card with the toy weights at the JAX
                 package's demo test settings (crop 64/256, 3 steps, 2
                 rounds of 2 poses, 4 conformers, physics correction and
                 ranking): finite top-5 RMSDs, a PDB with chains A and B and
                 an 11-atom ligand SDF
  9. train    -- the train CLI in process at full width: the medium preset
                 (random weights from a seed), crop 256/2048, 48
                 augmentation samples, 3 steps of one system, fp32, on a
                 dataset of the 4 demo systems; every loss finite, no
                 sampler retry, params and EMA moved, the step-3
                 checkpoint restores and its EMA exports as the JAX .npz
                 layout that loads into a fresh model with every key used
                 once; rows 5-6 on the tensor-core pair, the SIMT pair
                 never; seconds per step (the wait for the batch and its
                 copy included, and also shown alone), peak memory,
                 launches per step; then the same run with --bf16 (every
                 launch in bf16; its seconds per step and peak memory
                 printed beside the fp32 run's); then a run with
                 --use_mini_rollout --mini_rollout_steps 12 --alpha_pae 1
                 (the medium preset with its head): the pLDDT, PAE and PDE
                 losses logged and finite, the head's parameters and EMA
                 moved, and the EMA, head included, loads into a fresh
                 model with the head with every key used once
 9a. dp       -- the train CLI (toy, crop 128/1024, 8 samples, batch 2, 2
                 steps) without a process group and with --coordinator at
                 NCCL world size 1: step-1 loss terms within rel 1e-6, step
                 2's within 1e-4, the parameters' change within 1e-3 by
                 global norm (the backward's atomic adds differ run to
                 run); then the toy step (committed weights, the CPU
                 tests' parity optimizer) on 2 demo systems at crop
                 128/1024 as two gloo ranks on the card, one system each,
                 against the single-process step: the change of params,
                 Adam moments and EMA within rel 1e-4 by global norm, the
                 logs within 1e-4, rows 2 and 4-6 launched on each rank,
                 rows 5-6 on the tensor-core pair
 9b. tp       -- two gloo ranks on the card with the pair rows sharded
                 (tp=2): the toy trunk at crop 256/2048 on 5SAK (s and z
                 within rel 1e-4 of tp 1, each rank's peak memory above
                 the weights beside tp 1's, the row-sharded attention
                 taken), the toy train step at crop 128/1024 (its change
                 within rel 1e-4 of tp 1 by global norm, rows 2 and 4-6
                 launched, 5-6 on the tensor-core pair), and the main
                 dock's system and settings through
                 DockingPipeline(SamplerSettings(tp=2)), featurized in
                 process (launch counters reset before and read after;
                 rows 1-4 launched; top-1 within 0.5 A of the CPU
                 reading; both ranks' poses equal; rank 0 alone writes),
                 each beside its tp=1 run in this process
 9c. resume   -- a toy train run on the keyed draws at the gate's recipe
                 (random weights from seed 0, bf16, 8 samples, lr 1e-3,
                 warmup 100; 5SAK at crop 128/1024 featurized once) of 2
                 steps, its train state saved and restored into a fresh
                 model, then 2 more, against 4 steps in one call: every
                 loss term of every step equal bit for bit, under
                 torch.use_deterministic_algorithms (the index_select
                 backward's atomic adds otherwise differ run to run)
 9d. graph    -- the same recipe and system, 4 steps with each system's
                 forward and backward replayed as CUDA graphs
                 (make_train_step(cuda_graph=True), the gate's step on
                 the card) against 4 eager steps from one init, under
                 torch.use_deterministic_algorithms: every loss term and
                 every parameter bit for bit; then both steps' s/step
 10. lockstep -- two ligand-systems of one shape (demo receptor 6kzd, two
                 demo SMILES, crop 256/2048, 20 poses each, guided, with a
                 different adaptive factor each) for 4 steps through the
                 batched sampler with caller-given noise, and each through
                 the single-system sampler with its slice of that noise:
                 coordinates within 1e-2 A at every step
 11. screen   -- the screening CLI in process: the 8 SMILES of
                 demo/screening/demo_db.txt into 6kzd.pkl.gz with the main
                 dock's settings but 20 poses kept (max_samples = poses
                 per round), once one ligand at a time
                 (--vs_batch_size 1) and once in groups
                 (--vs_batch_size 4), launch and bias-expansion counters
                 reset before each and read after; no error entry, 20
                 poses per ligand, finite coordinates in the written PDB
                 and SDF files, no bias expanded in the batched screen, and
                 row 1 launched as often per group-round as per
                 single-ligand round; ligands/s and poses/s of both; then
                 a sequential screen of the first 2 SMILES with the
                 confidence weights and both confidence flags, each result
                 with one confidence entry per pose
 12. summary  -- the per-kernel JSON line (six rows; launches from the
                 main dock for rows 1-4 and from the train run for rows
                 5-6, and for rows 1-4 those of both screens and of the
                 dock_many and batched redocks; per row also
                 its launches in the confidence dock, in its head alone
                 and per mini-rollout train step, in the tp dock, the tp
                 train step and the dp step (rank 0), rows 3-4 their times
                 at the head's sites, and every row its tp sites), the
                 whole run's wall,
                 the card line, and last the {"ok": true, ...} line

It imports nothing of JAX, starts no process other than nvcc, g++, nvidia-smi,
the featurizer worker of the redocking CLI's multi-system runs (stopped
when each run ends; the train run's prefetch is a thread, stopped when
it ends) and the two ranks of the dp and tp phases (joined before the
phase reads their results), and exits non-zero without a result when
CUDA is absent or the port's package is not beside it.
"""

from __future__ import annotations

import dataclasses
import glob
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SYSTEMS = os.path.join(REPO, "demo", "redocking", "Posebusters_subset")
SCREEN = os.path.join(REPO, "demo", "screening")
H100_BYTES_PER_S = 3.35e12
# H100 SXM, dense, tensor cores (fp32 runs as TF32, counted as one pass)
TC_PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
EXP_PER_S = 3.9e12  # special-function unit, 16 per SM per clock
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARAMS = os.path.join(REPO, "_overfit", "ema_params.npz")
CONF_PARAMS = os.path.join(REPO, "_confidence", "ema_params_conf.npz")
MODEL_REL = 1e-3
# 5SAK_ZRY_A_1 at crop 256/2048 with the toy weights, which were trained at
# crop 128/1024 only: the JAX CLI on the CPU gives a top-ranked 4.34-4.38 A
# and the port on the CPU 4.34-4.37 A. A wrong kernel lands poses far off.
MAIN_RMSD_REF, MAIN_RMSD_TOL = 4.36, 0.5
# this script's wall before the confidence phases were added (NVIDIA H100
# 80GB HBM3, 700 W)
EARLIER_WALL_S = 241


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- kernels


def _sass_counts(tool, lib):
    """{function: {"HGMMA": n, "LDGSTS": n}} of a library's SASS."""
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"{tool} -sass: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {"HGMMA": 0, "LDGSTS": 0}
        elif fn is not None:
            for op in ("HGMMA", "LDGSTS"):
                counts[fn][op] += op in line
    return counts


# tensor-core kernels and their instance counts: the forward at 3 head dims
# x 4 dtype pairs x 1 or 2 warpgroups (fp32 at D = 128: 1); the backward's
# two kernels at D 32 and 64 x 4 dtype pairs
TC_KERNELS = {"flash_fwd": {"flash_fwd_tc": 22}, "flash_bwd": {"dq_dbias_tc": 8, "dkdv_tc": 8}}


def check_sass():
    """Every instance of the tensor-core kernels in the built libraries runs
    wgmma (SASS HGMMA) and fills its tiles with cp.async (SASS LDGSTS)."""
    import shutil

    from physdock_tpu_torch.ops import _flash_lib

    tool = os.path.join(os.path.dirname(_flash_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        fail("cuobjdump not found beside nvcc or on PATH")
    for lib, kernels in TC_KERNELS.items():
        counts = _sass_counts(tool, _flash_lib.lib_path(lib))
        simt = {f: c for f, c in counts.items() if "_kernel" in f}
        log(f"[build] {tool} -sass {lib}: {len(simt)} SIMT instances, HGMMA "
            f"{sum(c['HGMMA'] for c in simt.values())}")
        for kernel, want in kernels.items():
            tc = {f: c for f, c in counts.items() if kernel in f}
            log(f"[build]   {len(tc)} {kernel} instances, HGMMA {sorted(c['HGMMA'] for c in tc.values())}, "
                f"LDGSTS {sorted(c['LDGSTS'] for c in tc.values())}")
            bad = [f for f, c in tc.items() if not (c["HGMMA"] > 0 and c["LDGSTS"] > 0)]
            if len(tc) != want or bad:
                fail(f"{kernel}: {len(tc)} instances (want {want}); without HGMMA or LDGSTS: {bad}")


def kernel_cases():
    """(name, TPU kernel it replaces, call-site shape at crop 256/2048 with
    20 poses per round)."""
    return [
        ("flash_sdpa_folded_v3",
         "physdock_tpu/ops/flash_attention_folded_v3.py:115",
         dict(layout="folded", B=20, H=4, S=2048, D=32)),
        ("flash_sdpa_grouped",
         "physdock_tpu/ops/flash_attention_grouped.py:92",
         dict(layout="split", B=20, H=16, S=256, D=32)),
        ("flash_sdpa_folded",
         "physdock_tpu/ops/flash_attention_folded.py:143",
         dict(layout="folded", B=256, H=4, S=256, D=32)),
        ("flash_sdpa",
         "physdock_tpu/ops/flash_attention.py:71",
         dict(layout="single", B=1, H=4, S=2048, D=32)),
    ]


# row 1 at the batched screen's atom-DiT site: 4 systems of 20 samples,
# rows sample-major, one [4, S, S] bias per system
SCREEN_SITE = ("flash_sdpa_folded_v3", dict(layout="folded", B=80, H=4, S=1920, D=32, systems=4))
# row 3 at the batched redock's atom-DiT site (`--dock_batch_size 4` at
# crop 128/1024): the 4 demo systems re-padded to the chunk's largest
# bucket, 896 atoms (phase_redock_many checks that the run padded to it),
# 20 samples each, one [4, S, S] bias per system
REDOCK_SITE = ("flash_sdpa_folded", dict(layout="folded", B=80, H=4, S=896, D=32, systems=4))


def heads_view(x, layout, H):
    """The [..., H, S, D] view the attention modules pass: heads split
    from [B, S, H*D] ("heads") or [S, H*D] ("heads_single"). Other
    layouts are returned as they are."""
    if layout in ("heads", "heads_single"):
        return x.unflatten(-1, (H, -1)).transpose(-3, -2)
    return x


def make_inputs(torch, spec, dtype, seed):
    """q/k/v in the call site's layout and a [H, S, S] bias ([G, H, S, S]
    for a site of G `systems`) with the two mask tiers: random keys at
    -1e9, whole rows at -1e9 (fully masked), and the last eighth of the
    keys at -2e9 on top (pad tier); no bias where the site has none
    (`bias=False`)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, S, D = spec["B"], spec["H"], spec["S"], spec["D"]
    layout = spec["layout"]
    shape = {"folded": (B, S, H * D), "split": (B, H, S, D), "single": (H, S, D),
             "heads": (B, S, H * D), "heads_single": (S, H * D)}[layout]
    q, k, v = (heads_view(torch.randn(shape, generator=g, device="cuda").to(dtype), layout, H)
               for _ in range(3))
    if not spec.get("bias", True):
        return q, k, v, None
    bias = torch.randn(((spec["systems"],) if "systems" in spec else ()) + (H, S, S),
                       generator=g, device="cuda")
    mask = torch.rand((S, S), generator=g, device="cuda") < 0.2
    mask[: S // 16] = True  # fully masked rows
    pad = torch.zeros((S, S), dtype=torch.bool, device="cuda")
    pad[:, S - S // 8:] = True
    bias = bias + torch.where(mask, -1e9, 0.0) + torch.where(pad, -2e9, 0.0)
    return q, k, v, bias.to(dtype)


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_ms(torch, fn, reps):
    """Device milliseconds per call: `reps` calls captured in one CUDA
    graph and replayed between two events, so the host's launch overhead
    (the Python of a wrapper, tens of microseconds) does not hide a kernel
    shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # first call (builds, kernel attributes) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def query_rows(x, layout, lo, hi):
    """Rows lo..hi-1 of the query axis of an input in a call site's layout
    (what a tp rank holds of q, or of a bias with layout "bias")."""
    axis = {"folded": 1, "split": 2, "heads": 2, "heads_single": 1, "bias": -2}[layout]
    return x.narrow(axis if axis >= 0 else x.dim() + axis, lo, hi - lo)


def run_kernel_case(torch, name, spec, dtype, seed=None, rows=None):
    """One forward wrapper at a call site against its plain version, with
    the timings; `rows` (lo, hi) keeps those query rows of q and of the
    bias, as a tp rank calls the kernel (S_q = hi - lo against all S_k)."""
    import torch.nn.functional as F

    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.ops.flash_attention import flash_sdpa
    from physdock_tpu_torch.ops.flash_attention_folded import (
        flash_sdpa_folded,
        split_view,
    )
    from physdock_tpu_torch.ops.flash_attention_folded_v3 import flash_sdpa_folded_v3
    from physdock_tpu_torch.ops.flash_attention_grouped import flash_sdpa_grouped

    q, k, v, bias = make_inputs(torch, spec, dtype, seed=len(name) if seed is None else seed)
    H = spec["H"]
    G = spec.get("systems", 1)
    S_q = spec["S"] if rows is None else rows[1] - rows[0]
    if rows is not None:
        q = query_rows(q, spec["layout"], *rows)
        bias = None if bias is None else query_rows(bias, "bias", *rows)
    if spec["layout"] == "folded":
        wrapper = flash_sdpa_folded_v3 if name == "flash_sdpa_folded_v3" else flash_sdpa_folded
        kern = lambda: wrapper(q, k, v, bias, H)  # noqa: E731
        qs, ks, vs = (split_view(x, H) for x in (q, k, v))
        plain = lambda: _flash_lib.shared_plain(qs, ks, vs, bias)  # noqa: E731
        to_split = lambda o: split_view(o, H)  # noqa: E731
    else:
        wrapper = flash_sdpa_grouped if name == "flash_sdpa_grouped" else flash_sdpa
        kern = lambda: wrapper(q, k, v, bias)  # noqa: E731
        qs, ks, vs = q, k, v
        plain = lambda: _flash_lib.sdpa_plain(q, k, v, bias)  # noqa: E731
        to_split = lambda o: o  # noqa: E731
    o_kernel = to_split(kern()).float()
    torch.cuda.synchronize()
    o_plain = plain().float()
    err = float((o_kernel - o_plain).abs().max())
    finite = bool(torch.isfinite(o_kernel).all())
    mask_b = None if bias is None else bias.to(q.dtype)
    # the library call over [B/G, G, ...] views, each system's bias broadcast
    ql, kl, vl = (x.unflatten(0, (-1, G)) if G > 1 else x for x in (qs, ks, vs))
    lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask_b)  # noqa: E731
    # the SIMT kernel on the same inputs: the forward with stats
    B, S, D = spec["B"], spec["S"], spec["D"]
    qf, kf, vf = (x.reshape(-1, H, x.shape[-2], D) for x in (qs, ks, vs))
    b3, lead = (None, 0) if bias is None else (bias.reshape(-1, S_q, S).contiguous(), G * H)
    before = lambda: _flash_lib.launch(qf, kf, vf, b3, lead, stats=True, simt=True)  # noqa: E731
    _flash_lib.reset_launches()
    before()
    if _flash_lib.ROUTES["fwd_lse_simt"] != 1:
        fail(f"{name}: before_ms would not time the SIMT kernel: {_flash_lib.ROUTES}")
    reps = 20 if spec["S"] >= 2048 else 50
    ms = time_graph_ms(torch, kern, reps)
    before_ms = time_graph_ms(torch, before, reps)
    plain_ms = time_graph_ms(torch, plain, max(3, reps // 5))
    library_ms = time_graph_ms(torch, lib, reps)
    isz = torch.tensor([], dtype=dtype).element_size()
    dname = str(dtype).replace("torch.", "")
    # q, k, v, o, bias once each; the products on the tensor cores; one
    # exponential per logit
    bounds = {
        "bytes": (2 * B * H * (S_q + S) * D + (0 if bias is None else G * H * S_q * S)) * isz
        / H100_BYTES_PER_S * 1e3,
        "operations": 4 * B * H * S_q * S * D / TC_PEAK_FLOPS[dname] * 1e3,
        "exp": B * H * S_q * S / EXP_PER_S * 1e3,
    }
    bound_by = max(bounds, key=bounds.get)
    row = {
        "name": name, "dtype": dname, "max_abs_err": err, "finite": finite,
        "ms": ms, "before_ms": before_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bounds[bound_by], "bound_by": bound_by,
        "shape": {k: spec[k] for k in ("B", "H", "S", "D")}, "layout": spec["layout"],
        "lead": lead, "S_q": S_q,
    }
    log(f"  {json.dumps(row)}")
    if not finite or err > TOL[dname]:
        fail(f"{name} {dname}: max abs err {err} > {TOL[dname]} (finite={finite})")
    return row


def phase_kernels(torch):
    rows = {}
    for name, replaces, spec in kernel_cases():
        for dtype in (torch.float32, torch.bfloat16):
            r = run_kernel_case(torch, name, spec, dtype)
            r["replaces"] = replaces
            rows[(name, r["dtype"])] = r
    for tag, (name, spec) in (("screen", SCREEN_SITE), ("redock", REDOCK_SITE)):
        for dtype in (torch.float32, torch.bfloat16):
            log(f"  {name} at the batched {tag}'s site:")
            r = run_kernel_case(torch, name, spec, dtype, seed=spec["B"] + spec["S"])
            rows[(name, tag, r["dtype"])] = r
    return rows


# -------------------------------------------------------- training kernels


TRAIN_KERNELS = [
    ("flash_fwd_lse", "physdock_tpu/ops/flash_attention_bwd.py:41",
     "physdock_tpu_torch/csrc/flash_fwd.cu"),
    ("flash_bwd", "physdock_tpu/ops/flash_attention_bwd.py:216",
     "physdock_tpu_torch/csrc/flash_bwd.cu"),
]
# the two training call sites of rows 5-6 at crop 256/2048, 48 samples
TRAIN_SHAPES = {
    "atom_dit": dict(layout="folded", B=48, H=4, S=2048, D=32),
    "triangle": dict(layout="folded", B=256, H=4, S=256, D=32),
}


# the forward kernels' call sites in the same training step (crop 256/2048,
# 48 samples, the medium preset's widths), where they run as the forward
# of the recomputing autograd Function; views with the modules' strides.
# The MSA depth is the demo data's: 2 rows in training mode at crop 256;
# the MSA columns attend over those rows, one batch entry per token.
TRAIN_FWD_SITES = [
    ("flash_sdpa_grouped", "token_dit", dict(layout="heads", B=48, H=16, S=256, D=32)),
    ("flash_sdpa_grouped", "msa_row", dict(layout="heads", B=2, H=8, S=256, D=32)),
    ("flash_sdpa", "pair_single", dict(layout="heads_single", B=1, H=16, S=256, D=32)),
    ("flash_sdpa", "trunk_atom", dict(layout="heads_single", B=1, H=4, S=2048, D=32)),
    ("flash_sdpa", "msa_col", dict(layout="heads", B=256, H=8, S=2, D=32, bias=False)),
]


# the confidence head's call sites in the confidence dock (crop 128/1024:
# 128 tokens, 832 atoms after padding), one pose at a time; at crop
# 256/2048 they are the shapes of the trunk's sites above
CONF_SITES = [
    ("flash_sdpa_folded", "head_triangle", dict(layout="folded", B=128, H=4, S=128, D=32)),
    ("flash_sdpa", "head_single", dict(layout="heads_single", B=1, H=16, S=128, D=32)),
    ("flash_sdpa", "head_atom", dict(layout="heads_single", B=1, H=4, S=832, D=32)),
]


def phase_conf_kernels(torch):
    rows = {}
    for name, site, spec in CONF_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            log(f"  {name} at the confidence head's site {site}:")
            r = run_kernel_case(torch, name, spec, dtype, seed=spec["B"] + spec["H"] + spec["S"] + 1)
            rows[(name, site, r["dtype"])] = r
    return rows


def _rel(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def run_train_kernel_case(torch, site, spec, dtype, rows=None):
    """Rows 5 and 6 at one call site against their plain versions, with
    the memory-efficient SDPA as the yardstick and the SIMT pair at the
    same inputs as `before_ms`; `rows` (lo, hi) keeps those query rows of
    q and of the bias, as a tp rank calls them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.ops.flash_attention_bwd import (
        flash_bwd,
        flash_bwd_plain,
        flash_fwd_lse,
        flash_fwd_lse_plain,
    )
    from physdock_tpu_torch.ops.flash_attention_folded import split_view

    B, H, S, D = spec["B"], spec["H"], spec["S"], spec["D"]
    S_q = S if rows is None else rows[1] - rows[0]
    q, k, v, bias = make_inputs(torch, spec, dtype, seed=S + B)
    if rows is not None:
        q, bias = query_rows(q, "folded", *rows), query_rows(bias, "bias", *rows).contiguous()
    q, k, v = (split_view(x, H) for x in (q, k, v))  # [B, H, S, D] views, folded strides
    g = torch.Generator(device="cuda").manual_seed(B)
    do = split_view(torch.randn((B, S_q, H * D), generator=g, device="cuda").to(dtype), H)

    _flash_lib.reset_launches()
    o, m, l = flash_fwd_lse(q, k, v, bias)
    grads = flash_bwd(q, k, v, bias, o, m, l, do)
    torch.cuda.synchronize()
    routes = dict(_flash_lib.ROUTES)
    ro, rm, rl = flash_fwd_lse_plain(q, k, v, bias)
    ref = flash_bwd_plain(q, k, v, bias, o, m, l, do)
    dname = str(dtype).replace("torch.", "")
    errs = {"o": _rel(o, ro), "m": _rel(m, rm), "l": _rel(l, rl)}
    errs.update({n: _rel(x, r) for n, x, r in zip(("dq", "dk", "dv", "dbias"), grads, ref)})
    abs_fwd = max(float((a.float() - b.float()).abs().max()) for a, b in ((o, ro), (m, rm), (l, rl)))
    abs_bwd = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, ref))
    finite = all(bool(torch.isfinite(x).all()) for x in (o, m, l, *grads))
    del ro, rm, rl, ref

    fwd = lambda: flash_fwd_lse(q, k, v, bias)  # noqa: E731
    bwd = lambda: flash_bwd(q, k, v, bias, o, m, l, do)  # noqa: E731
    plain_fwd = lambda: flash_fwd_lse_plain(q, k, v, bias)  # noqa: E731
    plain_bwd = lambda: flash_bwd_plain(q, k, v, bias, o, m, l, do)  # noqa: E731
    # the SIMT pair on the same inputs, its backward on its own m and l
    _, sm, sl = _flash_lib.launch(q, k, v, bias, H, stats=True, simt=True)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    simt_fwd = lambda: _flash_lib.launch(q, k, v, bias, H, stats=True, simt=True)  # noqa: E731
    simt_bwd = lambda: _flash_lib.launch_bwd(q, k, v, bias, sm, sl, delta, do, simt=True)  # noqa: E731
    big = S >= 2048
    t = {"fwd": time_graph_ms(torch, fwd, 5 if big else 20),
         "bwd": time_graph_ms(torch, bwd, 3 if big else 10),
         "simt_fwd": time_graph_ms(torch, simt_fwd, 3 if big else 10),
         "simt_bwd": time_graph_ms(torch, simt_bwd, 2 if big else 5),
         "plain_fwd": time_ms(torch, plain_fwd, 2 if big else 5),
         "plain_bwd": time_ms(torch, plain_bwd, 2 if big else 5)}
    del sm, sl
    # yardstick: memory-efficient SDPA with the bias expanded over B, all
    # inputs requiring grad; timed only, never on the port's path
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
    lb = bias.to(dtype).detach().requires_grad_(True)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        run = lambda: F.scaled_dot_product_attention(  # noqa: E731
            lq, lk, lv, attn_mask=lb.expand(B, H, S_q, S))
        with torch.no_grad():
            t["sdpa_fwd"] = time_ms(torch, run, 5 if big else 20)
        out = run()
        t["sdpa_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (lq, lk, lv, lb), do, retain_graph=True), 3 if big else 10)
        t["sdpa_fwd_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            run(), (lq, lk, lv, lb), do), 3 if big else 10)
    del out

    isz = torch.tensor([], dtype=dtype).element_size()
    bq, bk = B * H * S_q * D, B * H * S * D  # one query-side, one key-side tensor
    out = {}
    for name, nbytes, flops, ms, before_ms, plain_ms, lib_ms, err, abs_err in (
        # q, k, v, bias read; o written; m, l fp32 written; two products
        ("flash_fwd_lse", (2 * bq + 2 * bk + H * S_q * S) * isz + 2 * B * H * S_q * 4,
         4 * B * H * S_q * S * D, t["fwd"], t["simt_fwd"], t["plain_fwd"], t["sdpa_fwd"],
         max(errs[n] for n in ("o", "m", "l")), abs_fwd),
        # q, k, v, o, do, bias read, m, l read; dq, dk, dv, dbias (fp32)
        # written; five products (s recomputed, dp, dv, dq, dk)
        ("flash_bwd", (4 * bq + 4 * bk + H * S_q * S) * isz + 2 * B * H * S_q * 4
         + H * S_q * S * 4,
         10 * B * H * S_q * S * D, t["bwd"], t["simt_bwd"], t["plain_bwd"], t["sdpa_bwd"],
         max(errs[n] for n in ("dq", "dk", "dv", "dbias")), abs_bwd),
    ):
        # the products at the tensor-core peak, one exp per logit
        bounds = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
                  "operations": flops / TC_PEAK_FLOPS[dname] * 1e3,
                  "exp": B * H * S_q * S / EXP_PER_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        out[name] = {
            "name": name, "site": site, "dtype": dname, "max_rel_err": err, "max_abs_err": abs_err,
            "ms": ms, "before_ms": before_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bounds[bound_by], "bound_by": bound_by, "S_q": S_q,
        }
    log(f"  {site} {dname} errs {json.dumps(errs)} times {json.dumps(t)} finite {finite} "
        f"routes {json.dumps(routes)}")
    for r in out.values():
        log(f"  {json.dumps(r)}")
    bad = {n: e for n, e in errs.items() if not e <= TOL[dname]}
    if bad or not finite:
        fail(f"training kernels at {site} {dname}: rel err over {TOL[dname]}: {bad} "
             f"(finite={finite})")
    if routes["fwd_lse_tc"] != 1 or routes["bwd_tc"] != 1:
        fail(f"training kernels at {site} {dname}: not on the tensor-core pair: {routes}")
    return out


def phase_train_kernels(torch):
    rows = {}
    for name, site, spec in TRAIN_FWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            log(f"  {name} at the training site {site}:")
            r = run_kernel_case(torch, name, spec, dtype, seed=spec["B"] + spec["H"] + spec["S"])
            rows[(name, site, r["dtype"])] = r
    for site, spec in TRAIN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for name, r in run_train_kernel_case(torch, site, spec, dtype).items():
                rows[(name, site, r["dtype"])] = r
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------- model


def model_outputs(torch, batch, x_hat, t_hat, device):
    """(a, ap, s, z, x_denoised) of the toy model on `device`, in fp32 on
    the CPU."""
    import numpy as np

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params

    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, PARAMS)
    model = model.to(device).eval()
    b = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
    with torch.no_grad():
        a, ap, s, z = model.conditioning(b)
        cache = model.denoise_bias_cache(b, ap, z)
        x = model.denoise(b, torch.from_numpy(x_hat).to(device),
                          torch.from_numpy(t_hat).to(device), a, ap, s, z, cache)
    return [t.float().cpu() for t in (a, ap, s, z, x)]


def phase_model(torch):
    import numpy as np

    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.ops import _flash_lib

    batch = make_synthetic_batch(n_tokens=256, n_atoms=2048, n_msa=8, n_ligand_tokens=32, seed=7)
    rng = np.random.default_rng(11)
    x_hat = (rng.normal(size=(2, 2048, 3)) * 16).astype(np.float32)
    t_hat = np.array([1.0, 80.0], np.float32)
    _flash_lib.reset_launches()
    card = model_outputs(torch, batch, x_hat, t_hat, "cuda")
    torch.cuda.synchronize()
    launches = dict(_flash_lib.LAUNCHES)
    plain = model_outputs(torch, batch, x_hat, t_hat, "cpu")
    errs = {}
    for name, o, r in zip(("a", "ap", "s", "z", "x_denoised"), card, plain):
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            fail(f"model {name}: shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        errs[name] = float((o - r).abs().max() / r.abs().max())
    log(f"[model] rel max abs err card vs CPU plain: {json.dumps(errs)}")
    log(f"[model] launches: {json.dumps(launches)}")
    bad = {k: v for k, v in errs.items() if not (v <= MODEL_REL)}
    if bad:
        fail(f"model on the card differs from the CPU by more than rel {MODEL_REL}: {bad}")
    missing = [k for k, _, _ in kernel_cases() if launches[k] <= 0]
    if missing:
        fail(f"model phase never launched: {missing}")
    phase_head(torch)


def conf_model(torch, cfg):
    """PhysDock with its confidence head and the committed confidence weights
    (every key of the file used once)."""
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params

    model = PhysDock(cfg.model, with_confidence=True)
    counts = load_jax_params(model, CONF_PARAMS)
    if counts["unused_head_keys"]:
        fail(f"confidence weights: {counts}")
    return model


def head_outputs(torch, batch, x_pred, device):
    """The confidence head's (p_pae, p_pde, p_plddt) of one pose on `device`
    from that device's own trunk, in fp32 on the CPU, and the launches of
    the head alone."""
    import numpy as np

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.ops import _flash_lib

    model = conf_model(torch, PhysDockConfig.named("toy")).to(device).eval()
    b = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
    with torch.no_grad():
        _, _, s, z = model.conditioning(b)
        if device == "cuda":
            torch.cuda.synchronize()
        _flash_lib.reset_launches()
        out = model.confidence(b, s, z, torch.from_numpy(x_pred).to(device))
        if device == "cuda":
            torch.cuda.synchronize()
    return [t.float().cpu() for t in out], dict(_flash_lib.LAUNCHES)


def phase_head(torch):
    import numpy as np

    from physdock_tpu_torch.data.synthetic import make_synthetic_batch

    t0 = time.time()
    batch = make_synthetic_batch(n_tokens=224, n_atoms=1792, n_msa=8, n_ligand_tokens=32, seed=9,
                                 pad_tokens=32, pad_atoms=256)
    rng = np.random.default_rng(13)
    x_pred = (np.asarray(batch["x_gt"], np.float32)[None]
              + rng.normal(size=(1, 2048, 3)) * 2.0).astype(np.float32)
    card, launches = head_outputs(torch, batch, x_pred, "cuda")
    plain, _ = head_outputs(torch, batch, x_pred, "cpu")
    errs = {}
    for name, o, r in zip(("p_pae", "p_pde", "p_plddt"), card, plain):
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            fail(f"confidence head {name}: shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        errs[name] = float((o - r).abs().max() / r.abs().max())
    log(f"[model] confidence head, 256 tokens (224 real) and 2048 atoms (1792 real), one pose: "
        f"rel max abs err card vs CPU plain {json.dumps(errs)} ({time.time() - t0:.2f} s)")
    log(f"[model] confidence head launches: {json.dumps(launches)}")
    bad = {k: v for k, v in errs.items() if not (v <= MODEL_REL)}
    if bad:
        fail(f"confidence head on the card differs from the CPU by more than rel {MODEL_REL}: {bad}")
    missing = [k for k in ("flash_sdpa_folded", "flash_sdpa") if launches[k] <= 0]
    if missing:
        fail(f"confidence head never launched {missing}")


def recycle_outputs(torch, batch, device):
    """(s, z) of the toy conditioning with one recycle: the committed toy
    weights, and the four recycle tensors from a numpy seed (non-zero; they
    are zero-initialised, so at init a wrong loop would not show)."""
    import numpy as np

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.train.checkpoint import load_params_npz

    model = PhysDock(dataclasses.replace(PhysDockConfig.named("toy").model, num_recycles=1))
    sd = load_params_npz(PARAMS)
    rng = np.random.default_rng(21)
    for n, t in model.state_dict().items():
        if ".recycle_" in n:
            a = (1.0 + 0.2 * rng.normal(size=t.shape) if "norm" in n
                 else 0.05 * rng.normal(size=t.shape))
            sd[n] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd, strict=True)
    model = model.to(device).eval()
    b = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
    with torch.no_grad():
        _, _, s, z = model.conditioning(b)
    return [t.float().cpu() for t in (s, z)]


def phase_recycle(torch):
    """recycle: the toy conditioning with num_recycles=1 and non-zero
    recycle projections at phase 5's shapes, on the card through the
    kernels and on the CPU through their plain versions: s and z within rel
    MODEL_REL of max|cpu|; rows 2 and 4 launched."""
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.ops import _flash_lib

    batch = make_synthetic_batch(n_tokens=256, n_atoms=2048, n_msa=8, n_ligand_tokens=32, seed=7)
    _flash_lib.reset_launches()
    card = recycle_outputs(torch, batch, "cuda")
    torch.cuda.synchronize()
    launches = dict(_flash_lib.LAUNCHES)
    plain = recycle_outputs(torch, batch, "cpu")
    errs = {}
    for name, o, r in zip(("s", "z"), card, plain):
        if o.shape != r.shape or not bool(torch.isfinite(o).all()):
            fail(f"recycle {name}: shape {tuple(o.shape)} vs {tuple(r.shape)}, or not finite")
        errs[name] = float((o - r).abs().max() / r.abs().max())
    log(f"[recycle] num_recycles=1, 256 tokens, 2048 atoms: rel max abs err card vs CPU plain "
        f"{json.dumps(errs)}; launches {json.dumps(launches)}")
    bad = {k: v for k, v in errs.items() if not (v <= MODEL_REL)}
    if bad:
        fail(f"recycle: the card differs from the CPU by more than rel {MODEL_REL}: {bad}")
    missing = [k for k in ("flash_sdpa_grouped", "flash_sdpa") if launches[k] <= 0]
    if missing:
        fail(f"recycle never launched {missing}")


# -------------------------------------------------------------------- grad

GRAD_REL_LOSS, GRAD_REL = 1e-4, 1e-3


def featurize_train(path, crop, atom_crop, seed=0):
    """One system featurized in training mode and padded to the crop."""
    from physdock_tpu_torch.config import DataConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.data.schema import FEATURE_SCHEMA
    from physdock_tpu_torch.data.synthetic import pad_batch

    feats, _ = SystemFeaturizer(DataConfig(crop_size=crop, atom_crop_size=atom_crop),
                                inference_mode=False, seed=seed, pad_to_bucket=False).load(path)
    return pad_batch({k: v for k, v in feats.items() if k in FEATURE_SCHEMA}, crop, atom_crop)


def train_loss_and_grads(torch, feats, device, n_aug=4, seed=0, bf16=False):
    """Loss, loss terms and every parameter's gradient of one training
    forward of the toy model with the committed weights on `device`, in
    fp32 or in bf16 compute (fp32 parameters and gradients); the draws
    come from the train step's CPU streams keyed by `seed` (step 0,
    system 0)."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.model.physdock import PhysDock, prepare_batch
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import make_train_step

    cfg = PhysDockConfig.named("toy", inference_mode=False, num_augmentation_sample=n_aug,
                               bf16=bf16)
    model = PhysDock(cfg.model, dtype=cfg.dtypes.compute_dtype)
    load_jax_params(model, PARAMS)
    model = model.to(device)
    step = make_train_step(model, make_optimizer(), cfg.loss, sigma_data=cfg.model.sigma_data)
    batch = prepare_batch(arrays_to_device(feats, device))
    loss, logs = step.loss_fn(batch, step.draw_system(batch, seed, 0, 0))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
             for (n, p), g in zip(named, grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}, grads


def mini_rollout_loss_and_grads(torch, feats, device, n_aug=4, seed=0):
    """Loss, loss terms and every parameter's gradient of one mini-rollout
    train step's system (corrupt-pose route, alpha_pae 1) of the model with
    the committed confidence weights on `device`; the draws come from the
    CPU streams keyed by `seed` (step 0, system 0)."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.model.physdock import prepare_batch
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import make_train_step

    cfg = PhysDockConfig.named("toy", inference_mode=False, num_augmentation_sample=n_aug)
    model = conf_model(torch, cfg).to(device)
    step = make_train_step(model, make_optimizer(), dataclasses.replace(cfg.loss, alpha_pae=1.0),
                           sigma_data=cfg.model.sigma_data, use_mini_rollout=True,
                           corrupt_rollout_pose=True)
    batch = prepare_batch(arrays_to_device(feats, device))
    loss, logs = step.loss_fn(batch, step.draw_system(batch, seed, 0, 0))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
             for (n, p), g in zip(named, grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}, grads


def compare_grads(tag, card, cpu):
    """Fails unless the card's loss is within rel GRAD_REL_LOSS of the CPU's
    and ||g_card - g_cpu|| <= GRAD_REL ||g_cpu|| over all parameters."""
    diff = math.sqrt(sum(float(((card[2][n] - g) ** 2).sum()) for n, g in cpu[2].items()))
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in cpu[2].values()))
    worst = max((float((card[2][n] - g).norm() / g.norm()), n)
                for n, g in cpu[2].items() if float(g.norm()) > 1e-8)
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    log(f"[grad] {tag}: loss card {card[0]!r} cpu {cpu[0]!r} (rel {loss_rel:.3e}); terms card "
        f"{json.dumps(card[1])} cpu {json.dumps(cpu[1])}")
    log(f"[grad] {tag}: ||g_card - g_cpu|| / ||g_cpu|| = {diff / norm:.3e} over {len(cpu[2])} "
        f"tensors (||g_cpu|| {norm:.4f}); worst tensor {worst[1]} rel {worst[0]:.3e}")
    if not (math.isfinite(card[0]) and loss_rel <= GRAD_REL_LOSS):
        fail(f"grad {tag}: card loss {card[0]} vs cpu {cpu[0]} (rel {loss_rel}) over {GRAD_REL_LOSS}")
    if not diff <= GRAD_REL * norm:
        fail(f"grad {tag}: ||g_card - g_cpu|| {diff} > {GRAD_REL} * ||g_cpu|| {norm}")


def phase_grad(torch):
    from physdock_tpu_torch.ops import _flash_lib

    feats = featurize_train(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), 128, 1024)
    _flash_lib.reset_launches()
    card = train_loss_and_grads(torch, feats, "cuda")
    torch.cuda.synchronize()
    launches, routes = dict(_flash_lib.LAUNCHES), dict(_flash_lib.ROUTES)
    cpu = train_loss_and_grads(torch, feats, "cpu")
    compare_grads("plain step", card, cpu)
    phase_grad_bf16(torch, feats, card)
    log(f"[grad] launches: {json.dumps(launches)}; rows 5-6 by design: {json.dumps(routes)}")
    want = ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa")
    missing = [n for n in want if launches[n] <= 0]
    stray = [n for n in ("flash_sdpa_folded", "flash_sdpa_folded_v3") if launches[n] != 0]
    if missing or stray:
        fail(f"grad: under grad, not launched {missing}, launched though folded {stray}")
    check_tc_routes("grad", routes)

    _flash_lib.reset_launches()
    card = mini_rollout_loss_and_grads(torch, feats, "cuda")
    torch.cuda.synchronize()
    launches, routes = dict(_flash_lib.LAUNCHES), dict(_flash_lib.ROUTES)
    cpu = mini_rollout_loss_and_grads(torch, feats, "cpu")
    compare_grads("mini-rollout step (corrupt pose)", card, cpu)
    head = {n: g for n, g in card[2].items() if n.startswith("confidence_module.")}
    dead = [n for n, g in head.items() if not float(g.abs().max()) > 0]
    head_diff = math.sqrt(sum(float(((g - cpu[2][n]) ** 2).sum()) for n, g in head.items()))
    head_norm = math.sqrt(sum(float((cpu[2][n] ** 2).sum()) for n in head))
    log(f"[grad] mini-rollout: {len(head)} head tensors, ||g_card - g_cpu|| / ||g_cpu|| over "
        f"them {head_diff / head_norm:.3e}; without a gradient on the card: {dead}")
    log(f"[grad] mini-rollout launches: {json.dumps(launches)}; rows 5-6: {json.dumps(routes)}")
    if dead or not {"plddt_loss", "pae_loss", "pde_loss"} <= set(card[1]):
        fail(f"grad mini-rollout: head tensors without gradient {dead}, or a loss missing: "
             f"{sorted(card[1])}")
    missing = [n for n in want if launches[n] <= 0]
    stray = [n for n in ("flash_sdpa_folded", "flash_sdpa_folded_v3") if launches[n] != 0]
    if missing or stray:
        fail(f"grad mini-rollout: not launched {missing}, launched though folded {stray}")
    check_tc_routes("grad mini-rollout", routes)


# the JAX package's own bf16 spread of one train step's gradient (relative
# global norm) and loss terms, measured by tests/test_torch_train_bf16.py
GRAD_BF16_REL, GRAD_BF16_TERMS = 4.61e-2, 3.68e-2


def phase_grad_bf16(torch, feats, card32):
    """grad bf16: the grad phase's step in bf16 compute on the card against
    the same step in fp32 on the card (`card32`): every loss term within rel
    GRAD_BF16_TERMS and ||g_bf16 - g_fp32|| <= GRAD_BF16_REL ||g_fp32||, the
    limits the JAX package's own bf16 spread sets
    (tests/test_torch_train_bf16.py); rows 5, 6, 2 and 4 launched, in bf16
    only, and rows 5-6 on the tensor-core pair."""
    from physdock_tpu_torch.ops import _flash_lib

    _flash_lib.reset_launches()
    card16 = train_loss_and_grads(torch, feats, "cuda", bf16=True)
    torch.cuda.synchronize()
    launches, routes, dtypes = (dict(_flash_lib.LAUNCHES), dict(_flash_lib.ROUTES),
                                dict(_flash_lib.DTYPES))
    diff = math.sqrt(sum(float(((card16[2][n] - g) ** 2).sum()) for n, g in card32[2].items()))
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in card32[2].values()))
    terms = {k: abs(card16[1][k] - v) / abs(v) for k, v in card32[1].items() if v != 0}
    log(f"[grad] bf16 step vs fp32 step on the card: loss {card16[0]!r} vs {card32[0]!r}; terms "
        f"rel {json.dumps(terms)}; ||g_bf16 - g_fp32|| / ||g_fp32|| = {diff / norm:.3e} "
        f"(limits {GRAD_BF16_TERMS}, {GRAD_BF16_REL})")
    log(f"[grad] bf16 launches: {json.dumps(launches)}; rows 5-6: {json.dumps(routes)}; "
        f"by dtype: {json.dumps(dtypes)}")
    zero = [k for k, v in card32[1].items() if v == 0 and card16[1][k] != 0]
    if not all(math.isfinite(v) for v in card16[1].values()) or zero or not all(
            v <= GRAD_BF16_TERMS for v in terms.values()):
        fail(f"grad bf16: loss terms {card16[1]} vs fp32 {card32[1]} beyond rel {GRAD_BF16_TERMS}")
    if not diff <= GRAD_BF16_REL * norm:
        fail(f"grad bf16: ||g_bf16 - g_fp32|| {diff} > {GRAD_BF16_REL} * ||g_fp32|| {norm}")
    missing = [n for n in ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa")
               if launches[n] <= 0]
    if missing or dtypes["float32"] or not dtypes["bfloat16"]:
        fail(f"grad bf16: not launched {missing}, or launches by dtype {dtypes}")
    check_tc_routes("grad bf16", routes)


def check_tc_routes(phase, routes):
    """Rows 5-6 ran on the tensor-core pair and never on the SIMT pair."""
    if routes["fwd_lse_simt"] or routes["bwd_simt"] or not (routes["fwd_lse_tc"] and routes["bwd_tc"]):
        fail(f"{phase}: rows 5-6 not all on the tensor-core pair: {json.dumps(routes)}")


# ------------------------------------------------------------------- docks


def dock_args(inputs, out, crop, atom_crop, params=PARAMS, extra=()):
    """The redocking CLI's arguments with the accuracy gate's settings
    (OVERFIT_GATE.json: 40 steps, 2 rounds of 20 poses, 64 conformers,
    pocket cutoff 6 A, fp32)."""
    feats = os.path.join(REPO, "demo", "redocking", "features")
    return [
        *inputs, "-o", out, *extra,
        "--params", params,
        "--model_name", "toy", "--crop_size", str(crop), "--atom_crop_size", str(atom_crop),
        "--msa_features_dir", os.path.join(feats, "msa_features"),
        "--uniprot_msa_features_dir", os.path.join(feats, "uniprot_msa_features"),
        "--steps", "40", "--max_rounds", "2", "--num_samples_per_round", "20",
        "--max_samples", "40", "--num_confs", "64", "--pocket_cutoff", "6.0",
        "--use_pocket", "--use_key_res", "--enable_physics_correction",
        "--enable_ranking", "--device", "cuda",
    ]


def dock(inputs, out, crop, atom_crop, params=PARAMS, extra=()):
    """Guided redocking through the port's CLI entry point (`dock_args`)."""
    from physdock_tpu_torch.cli import redocking

    return redocking.main(dock_args(inputs, out, crop, atom_crop, params, extra))


class Timed:
    """Wraps `owner.attr` with a timer while installed (a context
    manager): the seconds of each call, the card synchronized around it."""

    def __init__(self, torch, owner, attr):
        self.torch, self.owner, self.attr, self.calls = torch, owner, attr, []

    def __enter__(self):
        self.orig = orig = getattr(self.owner, self.attr)

        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.time()
            out = orig(*args, **kw)
            self.torch.cuda.synchronize()
            self.calls.append(time.time() - t0)
            return out

        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


class Tee:
    """Keeps a copy of what is printed to stdout while installed."""

    def __enter__(self):
        self.out, self.buf = sys.stdout, io.StringIO()
        sys.stdout = self
        return self

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out


def check_bust_reports(tag, out, results):
    """Every system directory holds bust_report.json: one entry per written
    pose (five), each with its pose_valid verdict. Returns the top-1's
    verdicts."""
    top1 = {}
    for r in results:
        path = os.path.join(out, r["system_id"], "bust_report.json")
        if not os.path.exists(path):
            fail(f"{tag}: {path} missing")
        with open(path) as f:
            report = json.load(f)
        if len(report) != 5 or any("pose_valid" not in e for e in report) or [
                e["rank"] for e in report] != list(range(5)):
            fail(f"{tag}: {path}: not five ranked entries with pose_valid: {report}")
        top1[r["system_id"]] = report[0]["pose_valid"]
    return top1


def phase_accuracy(torch, work):
    """The 4 systems through the CLI, which takes more than one system
    through `dock_many`: the first featurized in process while the
    featurizer worker starts, the other three by the worker. Returns
    (top-1 RMSDs, results, the dock_many call's seconds, check_pose's
    seconds per system)."""
    from physdock_tpu_torch.infer import pipeline

    out = os.path.join(work, "accuracy")
    with Tee() as tee, Timed(torch, pipeline.DockingPipeline, "dock_many") as many, \
            Timed(torch, pipeline, "check_pose") as checks:
        results = dock(["-f", SYSTEMS], out, 128, 1024)
    if "[dock_many failed" in tee.buf.getvalue() or len(many.calls) != 1:
        fail(f"accuracy dock did not go through dock_many ({len(many.calls)} calls)")
    if len(results) != 4:
        fail(f"accuracy dock returned {len(results)} results, expected 4")
    tops = {}
    for i, r in enumerate(results):
        if "error" in r or not r.get("top5_rmsd"):
            fail(f"accuracy dock: {r.get('system_id')}: {r.get('error', 'no rmsd')}")
        detail = r["timings"].get("load_detail") or {}
        if (i == 0) != (not detail) or detail and not {
                "wait_s", "read_s", "mb", "worker_s"} <= set(detail):
            fail(f"accuracy dock: {r['system_id']}: system {i} should be featurized "
                 f"{'in process' if i == 0 else 'by the worker (its receive timings)'}: "
                 f"{r['timings']}")
        tops[r["system_id"]] = r["top5_rmsd"][0]
    valid = check_bust_reports("accuracy dock", out, results)
    log(f"[accuracy] dock_many {many.calls[0]:.2f} s; per system load_s "
        f"{[r['timings']['load_s'] for r in results]}, worker receive (systems 2-4) "
        f"{json.dumps([r['timings']['load_detail'] for r in results[1:]])}; top-1 pose_valid "
        f"{json.dumps(valid)}; check_pose {sum(checks.calls) / len(results):.4f} s per system "
        f"({len(checks.calls)} poses)")
    return tops, results, many.calls[0], sum(checks.calls) / len(results)


def phase_accuracy_bf16(torch, work, tops32):
    """accuracy bf16: the accuracy dock with --bf16, counters reset before
    and read after: top-1 < 2 A on 4/4, each system printed beside its fp32
    top-1 of this run; rows 2-4 launched, every launch in bf16, the SIMT
    route never."""
    from physdock_tpu_torch.ops import _flash_lib

    out = os.path.join(work, "accuracy_bf16")
    _flash_lib.reset_launches()
    results = dock(["-f", SYSTEMS], out, 128, 1024, extra=["--bf16"])
    torch.cuda.synchronize()
    launches, routes, dtypes = (dict(_flash_lib.LAUNCHES), dict(_flash_lib.ROUTES),
                                dict(_flash_lib.DTYPES))
    tops = {}
    for r in results:
        if "error" in r or not r.get("top5_rmsd"):
            fail(f"accuracy bf16: {r.get('system_id')}: {r.get('error', 'no rmsd')}")
        tops[r["system_id"]] = r["top5_rmsd"][0]
    log(f"[accuracy bf16] top-ranked RMSD (A), bf16 / fp32: "
        f"{json.dumps({k: [v, tops32.get(k)] for k, v in tops.items()})}")
    log(f"[accuracy bf16] launches {json.dumps(launches)}; by dtype {json.dumps(dtypes)}; "
        f"routes {json.dumps(routes)}")
    bad = {k: v for k, v in tops.items() if not (v < 2.0)}
    if len(tops) != 4 or bad:
        fail(f"accuracy bf16: top-ranked RMSD >= 2 A or systems missing: {tops}")
    missing = [k for k in ("flash_sdpa_grouped", "flash_sdpa_folded", "flash_sdpa")
               if launches[k] <= 0]
    if missing or dtypes["float32"] or not dtypes["bfloat16"] or routes["fwd_lse_simt"] \
            or routes["bwd_simt"]:
        fail(f"accuracy bf16: not launched {missing}, launches by dtype {dtypes}, routes {routes}")
    return tops


def phase_redock_many(torch, work, card, acc_results, many_s, check_s):
    """The accuracy dock's 4 systems again: one after the other with
    `DockingPipeline.dock`, featurized in process (each held to its
    dock_many result; the same warm process, so the two walls compare the
    worker's prefetch and offload against none), then
    batched by 4 through the CLI (counts reset before, read after), then
    one system with side-chain relaxation. Returns the batched run's
    launches."""
    import argparse

    import numpy as np

    from physdock_tpu_torch.cli.common import add_common_flags, build_pipeline
    from physdock_tpu_torch.infer import pipeline
    from physdock_tpu_torch.ops import _flash_lib

    parser = argparse.ArgumentParser()
    add_common_flags(parser)
    out = os.path.join(work, "sequential")
    pipe = build_pipeline(parser.parse_args(dock_args([], out, 128, 1024)))
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        seq = [pipe.dock(path, os.path.join(out, os.path.basename(path)[: -len(".pkl.gz")]))
               for path in sorted(glob.glob(os.path.join(SYSTEMS, "*.pkl.gz")))]
        torch.cuda.synchronize()
        seq_s = time.time() - t0
    finally:
        pipe.close()
    many = {r["system_id"]: r for r in acc_results}
    for r in seq:
        m = many[r["system_id"]]
        err = float(np.max(np.abs(np.subtract(r["all_rmsd"], m["all_rmsd"]))))
        if r["rank_order"] != m["rank_order"] or not err <= 1e-4:
            fail(f"redock_many: {r['system_id']}: sequential dock differs from dock_many: rank "
                 f"order {r['rank_order']} / {m['rank_order']}, max RMSD difference {err} A")
    log(f"[redock_many] 4 systems one after the other (DockingPipeline.dock, featurized in "
        f"process) {seq_s:.2f} s, through dock_many with the worker {many_s:.2f} s "
        f"({seq_s / many_s:.3f}x); every system's rank order and pose RMSDs equal within "
        f"1e-4 A; load_s sequential {[r['timings']['load_s'] for r in seq]}, dock_many "
        f"{[r['timings']['load_s'] for r in acc_results]} ({card})")

    out = os.path.join(work, "batched")
    torch.cuda.synchronize()
    _flash_lib.reset_launches()
    with Timed(torch, pipeline.DockingPipeline, "dock_many") as timer:
        batched = dock(["-f", SYSTEMS], out, 128, 1024, extra=["--dock_batch_size", "4"])
    torch.cuda.synchronize()
    launches = dict(_flash_lib.LAUNCHES)
    if len(batched) != 4 or any("error" in r or not r.get("top5_rmsd") for r in batched):
        fail(f"batched redock: {batched}")
    tops = {r["system_id"]: r["top5_rmsd"][0] for r in batched}
    groups = {r["system_id"]: r.get("vs_batch_size", 1) for r in batched}
    rounds = sorted({r["timings"]["rounds_s"] for r in batched})  # one per group
    padded = {r["n_atoms_padded"] for r in batched if r.get("vs_batch_size", 1) == 4}
    if padded != {REDOCK_SITE[1]["S"]}:
        fail(f"batched redock padded its group to {padded} atoms, not REDOCK_SITE's "
             f"{REDOCK_SITE[1]['S']}: the kernel check ran at another shape")
    valid = check_bust_reports("batched redock", out, batched)
    log(f"[redock_many] --dock_batch_size 4: {timer.calls[0]:.2f} s in dock_many "
        f"({seq_s / timer.calls[0]:.3f}x the sequential wall); group size per system "
        f"{json.dumps(groups)}; rounds_s per group {rounds} (summed "
        f"{sum(rounds):.3f}; the dock_many run's summed "
        f"{sum(r['timings']['rounds_s'] for r in acc_results):.3f}); top-1 RMSD (A) "
        f"{json.dumps(tops)}; top-1 pose_valid {json.dumps(valid)} ({card})")
    log(f"[redock_many]   launches: {json.dumps(launches)}; bias expansions "
        f"{json.dumps(_flash_lib.BIAS_EXPANSIONS)}")
    bad = {k: v for k, v in tops.items() if not (v < 2.0)}
    if bad:
        fail(f"batched redock: top-1 RMSD >= 2 A: {bad}")
    missing = [k for k, _, _ in kernel_cases() if k != "flash_sdpa_folded_v3" and launches[k] <= 0]
    if missing:  # the atom DiT takes row 3 below 1024 atoms
        fail(f"batched redock never launched {missing}")

    out = os.path.join(work, "relaxed")
    with Timed(torch, pipeline, "relax_complex") as relax:
        (r,) = dock(["-i", os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz")], out, 128, 1024,
                    extra=["--enable_sidechain_relaxation"])
    if "error" in r or not r.get("top5_rmsd") or not r["top5_rmsd"][0] < 2.0:
        fail(f"relaxed redock: {r}")
    valid = check_bust_reports("relaxed redock", out, [r])
    log(f"[redock_many] --enable_sidechain_relaxation, {r['system_id']}: top-1 "
        f"{r['top5_rmsd'][0]:.4f} A (the dock_many run's {many[r['system_id']]['top5_rmsd'][0]:.4f}); "
        f"relax_complex {sum(relax.calls):.3f} s over {len(relax.calls)} poses "
        f"({sum(relax.calls) / len(relax.calls):.4f} s per pose), check_pose {check_s:.4f} s per "
        f"system; rounds_s {r['timings']['rounds_s']}; top-1 pose_valid {json.dumps(valid)} "
        f"({card})")
    return launches


class HeadTimer:
    """Times the pipeline's `_confidence_scores` (the head over every pose of
    a dock) with the card synchronized around it, and apart the host's
    metrics inside it (`infer.metrics.get_metrics`, after the logits'
    copy to the host), and counts the launches made inside it, while
    installed (a context manager)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []  # (poses, seconds) per dock
        self.metrics_s = 0.0
        self.launches = {}

    def __enter__(self):
        from physdock_tpu_torch.infer import metrics as metrics_lib
        from physdock_tpu_torch.infer.pipeline import DockingPipeline
        from physdock_tpu_torch.ops import _flash_lib

        self.orig = orig = DockingPipeline._confidence_scores
        self.orig_metrics = orig_metrics = metrics_lib.get_metrics
        torch = self.torch

        def timed_metrics(*args, **kw):
            t0 = time.time()
            out = orig_metrics(*args, **kw)
            self.metrics_s += time.time() - t0
            return out

        def timed(pipe, batch, conditioning, poses, feats):
            torch.cuda.synchronize()
            before, t0 = dict(_flash_lib.LAUNCHES), time.time()
            out = orig(pipe, batch, conditioning, poses, feats)
            torch.cuda.synchronize()
            self.calls.append((len(poses), time.time() - t0))
            for k, n in _flash_lib.LAUNCHES.items():
                self.launches[k] = self.launches.get(k, 0) + n - before[k]
            return out

        DockingPipeline._confidence_scores = timed
        metrics_lib.get_metrics = timed_metrics
        return self

    def __exit__(self, *exc):
        from physdock_tpu_torch.infer import metrics as metrics_lib
        from physdock_tpu_torch.infer.pipeline import DockingPipeline

        DockingPipeline._confidence_scores = self.orig
        metrics_lib.get_metrics = self.orig_metrics


def check_confidence(tag, r, out_dir):
    """A result's per-pose confidence: one finite entry per pose in rank
    order, ranking_confidence non-increasing, the rank order the argsort
    of the float32 scores, confidence.json written."""
    import numpy as np

    conf = r.get("confidence")
    if not conf or len(conf) != r["num_poses"]:
        fail(f"{tag}: {r.get('system_id')}: {0 if not conf else len(conf)} confidence entries "
             f"for {r['num_poses']} poses")
    for m in conf:
        if not (all(math.isfinite(m[k]) for k in ("mean_plddt", "ptm", "iptm",
                                                   "ranking_confidence"))
                and 0 <= m["mean_plddt"] <= 100 and 0 <= m["ptm"] <= 1 and 0 <= m["iptm"] <= 1):
            fail(f"{tag}: {r.get('system_id')}: metrics out of range: {m}")
    # the poses are ranked by the scores in float32, as in the JAX package:
    # scores that differ below its precision tie, in argsort's order
    scores = [float(np.float32(m["ranking_confidence"])) for m in conf]
    if any(a < b for a, b in zip(scores, scores[1:])):
        fail(f"{tag}: ranking_confidence (float32) increases along the rank order: {scores}")
    # ties pass any order above, so the order itself must be the argsort of
    # the scores by pose
    by_pose = dict(zip(r["rank_order"], scores))
    expect = [int(i) for i in np.argsort(-np.asarray([by_pose[i] for i in range(len(conf))],
                                                     np.float32))]
    if r["rank_order"] != expect:
        fail(f"{tag}: {r.get('system_id')}: rank order {r['rank_order']} is not the argsort "
             f"of ranking_confidence {expect}")
    if not os.path.exists(os.path.join(out_dir, "confidence.json")):
        fail(f"{tag}: {out_dir}/confidence.json missing")


def phase_confidence(torch, work):
    """The accuracy dock with the confidence weights, ranked by confidence."""
    from physdock_tpu_torch.ops import _flash_lib

    out = os.path.join(work, "confidence")
    torch.cuda.synchronize()
    _flash_lib.reset_launches()
    t0 = time.time()
    with HeadTimer(torch) as timer:
        results = dock(["-f", SYSTEMS], out, 128, 1024, params=CONF_PARAMS,
                       extra=["--enable_confidence", "--confidence_ranking"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_flash_lib.LAUNCHES)
    if len(results) != 4:
        fail(f"confidence dock returned {len(results)} results, expected 4")
    tops = {}
    for r in results:
        if "error" in r or not r.get("top5_rmsd"):
            fail(f"confidence dock: {r.get('system_id')}: {r.get('error', 'no rmsd')}")
        check_confidence("confidence dock", r, os.path.join(out, r["system_id"]))
        tops[r["system_id"]] = r["top5_rmsd"][0]
        c0 = r["confidence"][0]
        log(f"[confidence] {r['system_id']}: confidence-ranked top-1 {r['top5_rmsd'][0]:.4f} A "
            f"(best of {r['num_poses']} poses {min(r['all_rmsd']):.4f} A); top-1 mean_plddt "
            f"{c0['mean_plddt']:.3f} ptm {c0['ptm']:.4f} iptm {c0['iptm']:.4f} "
            f"ranking_confidence {c0['ranking_confidence']:.4f}; rounds_s "
            f"{r['timings']['rounds_s']}")
    poses = sum(n for n, _ in timer.calls)
    head_s = sum(t for _, t in timer.calls)
    rounds_s = sum(r["timings"]["rounds_s"] for r in results)
    log(f"[confidence] head: {poses} poses in {head_s:.3f} s, {head_s / poses:.5f} s per pose "
        f"(per system {json.dumps([round(t / n, 5) for n, t in timer.calls])}), of which the "
        f"host's metrics {timer.metrics_s / poses:.5f} s per pose; trunk, sampler "
        f"and head together (rounds_s) {rounds_s:.3f} s, of which the head "
        f"{head_s / rounds_s:.1%}; wall {wall:.2f} s")
    log(f"[confidence] launches in the head: {json.dumps(timer.launches)}; in the whole dock: "
        f"{json.dumps(launches)}")
    bad = {k: v for k, v in tops.items() if not (v < 2.0)}
    if bad:
        fail(f"confidence dock: confidence-ranked top-1 RMSD >= 2 A: {bad}")
    missing = [k for k in ("flash_sdpa_folded", "flash_sdpa") if timer.launches[k] <= 0]
    if missing:
        fail(f"confidence dock: the head never launched {missing}")
    return tops, launches, timer.launches


def phase_main(work):
    """The main dock through the CLI: its results, and the poses and meta
    its post-processing was given (the native phase's inputs)."""
    from physdock_tpu_torch.infer.pipeline import DockingPipeline

    post = DockingPipeline._postprocess
    seen = []

    def keep(self, feats, meta, poses, *args, **kw):
        seen.append((poses, meta))
        return post(self, feats, meta, poses, *args, **kw)

    DockingPipeline._postprocess = keep
    try:
        res = dock(["-i", os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz")],
                   os.path.join(work, "main"), 256, 2048)
    finally:
        DockingPipeline._postprocess = post
    return res, seen[-1]


# -------------------------------------------------------------- screening

# max_samples equal to the poses per round, as in the reference CLI's
# defaults: the round protocol then delivers exactly max_samples poses,
# where with 40 it delivers between 20 and 40 (accepted poses are not
# backfilled once a round's worth passed the chirality check)
SCREEN_ROUNDS, SCREEN_POSES, SCREEN_MAX = 2, 20, 20


def screen_flags(out, batch_size, smiles=os.path.join(SCREEN, "demo_db.txt"), params=PARAMS,
                 extra=()):
    """The screening CLI's flags: the main dock's settings, 20 poses kept."""
    feats = os.path.join(SCREEN, "features")
    return [
        "-i", os.path.join(SCREEN, "6kzd.pkl.gz"), "-s", smiles, *extra,
        "-o", out, "--params", params, "--model_name", "toy",
        "--crop_size", "256", "--atom_crop_size", "2048",
        "--msa_features_dir", os.path.join(feats, "msa_features"),
        "--uniprot_msa_features_dir", os.path.join(feats, "uniprot_msa_features"),
        "--steps", "40", "--max_rounds", str(SCREEN_ROUNDS),
        "--num_samples_per_round", str(SCREEN_POSES), "--max_samples", str(SCREEN_MAX),
        "--num_confs", "64", "--pocket_cutoff", "6.0", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cuda",
        "--vs_batch_size", str(batch_size),
    ]


LOCKSTEP_STEPS, LOCKSTEP_ATOL = 4, 1e-2


def phase_lockstep(torch):
    """Two demo ligands of one shape group through the batched sampler and,
    each with its slice of the same noise, through the single-system one."""
    import argparse

    import numpy as np

    from physdock_tpu_torch.cli import common
    from physdock_tpu_torch.model.diffusion import (
        sample_diffusion,
        sample_diffusion_batched,
        stack_guidances,
        stacked_conditioning,
    )
    from physdock_tpu_torch.utils.io import load_txt

    p = argparse.ArgumentParser()  # the screening CLI's flags, for its pipeline
    for flag in ("-i", "-s", "--vs_batch_size"):
        p.add_argument(flag)
    common.add_common_flags(p)
    args = p.parse_args(screen_flags(os.path.join(REPO, "build", "unused"), 2))
    pipe = common.build_pipeline(args)
    s = pipe.s
    loaded = {}
    try:  # features, compact, and conformer banks through the pipeline's loader
        for smi in load_txt(os.path.join(SCREEN, "demo_db.txt")):
            feats, meta = pipe._load(args.i, remove_ligand=True, smi=smi, num_msa_rounds=1)
            sig = tuple(sorted((k, np.shape(v)) for k, v in feats.items()))
            loaded.setdefault(sig, []).append((feats, meta))
            if len(loaded[sig]) == 2:
                items = loaded[sig]
                break
        else:
            fail("lockstep: no two demo ligands share a shape group")
    finally:
        pipe.close()
    l_max = max(len(m["ligand_atom_idx"]) for _, m in items)
    guides = []
    for feats, meta in items:
        g, confs = pipe._build_guidance(feats, meta, pad_atoms=l_max)
        pos = np.zeros((s.max_samples, l_max, 3), np.float32)
        pos[:, : confs.shape[1]] = confs[: s.max_samples]
        guides.append(dataclasses.replace(
            g, conf_pos=torch.as_tensor(pos, device="cuda"),
            conf_dists=torch.as_tensor(np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1),
                                       device="cuda"),
            conf_mask=torch.ones(s.max_samples, device="cuda")))
    batches = [pipe._to_device(f) for f, _ in items]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    n_atoms = stacked["ref_pos"].shape[-2]
    rng = np.random.default_rng(0)
    T, S = LOCKSTEP_STEPS, SCREEN_POSES
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(2 * T * S)])
    noise = {
        "x_init_z": rng.normal(size=(2, S, n_atoms, 3)),
        "aug_R": rot.reshape(2, T, S, 3, 3),
        "aug_t": rng.normal(size=(2, T, S, 3)),
        "churn_z": rng.normal(size=(2, T, S, n_atoms, 3)),
    }
    noise = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda") for k, v in noise.items()}
    # eta and 100: at 4 steps (rho 1000: sigma 2560, 75, 2.2, 0.064) the
    # second step matches conformers in one system and relaxes in the other
    factors = [s.eta, 100.0]
    kw = dict(num_sample=S, steps=T, gamma_0=s.gamma_0, gamma_min=s.gamma_min,
              noise_scale_lambda=s.noise_scale_lambda, step_scale_eta=s.step_scale_eta,
              karras_rho=s.rho, mmff_iters=s.mmff_iters, align_ref_pos=True,
              return_trajectory=True)
    model = pipe.model
    with torch.no_grad():
        conds = stacked_conditioning(model, stacked)
        batched = sample_diffusion_batched(
            model, stacked, guidance=stack_guidances(guides), mmff_gamma_0_factor=factors,
            conditioning=conds, noise_override=noise, **kw)
        singles = [sample_diffusion(
            model, batches[b], guidance=guides[b], mmff_gamma_0_factor=factors[b],
            conditioning=tuple(c[b] for c in conds),
            noise_override={k: v[b] for k, v in noise.items()}, **kw) for b in range(2)]
    torch.cuda.synchronize()
    errs = [[float((batched[b, i] - singles[b][i]).abs().max()) for i in range(T)]
            for b in range(2)]
    finite = bool(torch.isfinite(batched).all())
    log(f"[lockstep] 2 systems of {n_atoms} atoms (ligands {[int(g.ligand_mask.sum()) for g in guides]}"
        f" atoms, padded to {l_max}), {S} poses, factors {factors}: max abs err per step "
        f"batched vs single (A): {json.dumps(errs)}; finite {finite}")
    if not finite or not max(max(e) for e in errs) <= LOCKSTEP_ATOL:
        fail(f"lockstep: batched and single-system samplers differ by more than {LOCKSTEP_ATOL} A")
    return errs


def _coords_finite(path):
    """Every coordinate of a written PDB (ATOM/HETATM columns 31-54) or SDF
    file is finite."""
    import numpy as np

    if path.endswith(".sdf"):
        from physdock_tpu_torch.data.mol import read_sdf

        mol = read_sdf(path)
        return mol.num_atoms > 0 and bool(np.all(np.isfinite(mol.coords)))
    with open(path) as f:
        xyz = [[float(ln[30 + 8 * j: 38 + 8 * j]) for j in range(3)]
               for ln in f if ln.startswith(("ATOM", "HETATM"))]
    return len(xyz) > 0 and bool(np.all(np.isfinite(xyz)))


def phase_screen(torch, work, card):
    """Both screening modes; returns {batch size: launches}."""
    from physdock_tpu_torch.cli import screening
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.utils.io import load_json, load_txt

    smiles = load_txt(os.path.join(SCREEN, "demo_db.txt"))
    cfg = PhysDockConfig.named("toy").model
    row1_per_round = 40 * 2 * cfg.no_blocks_atom  # steps x (encoder + decoder blocks)
    runs = {}
    for bs in (1, 4):
        out = os.path.join(work, f"screen_vs{bs}")
        torch.cuda.synchronize()
        _flash_lib.reset_launches()
        t0 = time.time()
        res = screening.main(screen_flags(out, bs))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, expansions = dict(_flash_lib.LAUNCHES), dict(_flash_lib.BIAS_EXPANSIONS)
        bad = [r for r in res if "error" in r or r.get("num_poses") != SCREEN_MAX]
        if len(res) != len(smiles) or bad:
            fail(f"screen vs{bs}: {len(res)} results for {len(smiles)} SMILES; "
                 f"errors or pose counts other than {SCREEN_MAX}: {bad}")
        md5 = load_json(os.path.join(out, "smiles_to_md5.json"))
        for r in res:
            d = os.path.join(out, md5[r["smiles"]])
            for name in ("pred_rank0.pdb", "ligand_rank0.sdf"):
                if not os.path.exists(os.path.join(d, name)):
                    fail(f"screen vs{bs}: {r['smiles']}: {name} missing")
            written = [f for f in os.listdir(d) if f.endswith((".pdb", ".sdf")) and "rank" in f]
            if not all(_coords_finite(os.path.join(d, f)) for f in written):
                fail(f"screen vs{bs}: {r['smiles']}: a non-finite coordinate in {written}")
        ligand_rounds = sum(r["rounds"] for r in res)
        group_rounds = sum(r["rounds"] / r.get("vs_batch_size", 1) for r in res)
        sampled = SCREEN_POSES * sum(r["rounds"] for r in res)
        delivered = sum(r["num_poses"] for r in res)
        t = {k: round(sum(r["timings"].get(k, 0.0) for r in res), 3)
             for k in ("load_s", "upload_s", "guidance_s", "rounds_s")}
        if bs > 1:  # group-level times, shared by the group's results
            for k in ("guidance_s", "rounds_s"):
                t[k] = round(sum(r["timings"][k] / r["vs_batch_size"] for r in res), 3)
        log(f"[screen] --vs_batch_size {bs}: {len(res)} ligands in {wall:.2f} s: "
            f"{len(res) / wall:.4f} ligands/s, {delivered / wall:.3f} poses/s delivered "
            f"({delivered} poses), {sampled / wall:.3f} poses/s sampled; rounds per ligand "
            f"{[r['rounds'] for r in res]}, groups {sorted(set(r.get('vs_batch_size', 1) for r in res))} "
            f"({card})")
        log(f"[screen]   summed timings (s): {json.dumps(t)}; per ligand load_s "
            f"{[r['timings']['load_s'] for r in res]}; atoms padded "
            f"{[r['n_atoms_padded'] for r in res]}")
        log(f"[screen]   launches: {json.dumps(launches)}; bias expansions {json.dumps(expansions)}; "
            f"row 1 per {'group-' if bs > 1 else 'ligand '}round "
            f"{launches['flash_sdpa_folded_v3'] / group_rounds:.1f} over {group_rounds:g} "
            f"({ligand_rounds} ligand rounds)")
        if launches["flash_sdpa_folded_v3"] != row1_per_round * group_rounds:
            fail(f"screen vs{bs}: row 1 launched {launches['flash_sdpa_folded_v3']} times, "
                 f"not {row1_per_round} per round over {group_rounds} rounds")
        if bs > 1 and any(expansions.values()):
            fail(f"screen vs{bs}: biases expanded: {expansions}")
        missing = [k for k, _, _ in kernel_cases() if launches[k] <= 0]
        if missing:
            fail(f"screen vs{bs}: never launched {missing}")
        runs[bs] = launches

    # one ligand after the other with the confidence weights, scored and
    # ranked by the head
    lib = os.path.join(work, "screen_conf.txt")
    with open(lib, "w") as f:
        f.write("\n".join(smiles[:2]) + "\n")
    out = os.path.join(work, "screen_conf")
    with HeadTimer(torch) as timer:
        res = screening.main(screen_flags(out, 1, smiles=lib, params=CONF_PARAMS,
                                          extra=["--enable_confidence", "--confidence_ranking"]))
    md5 = load_json(os.path.join(out, "smiles_to_md5.json"))
    if len(res) != 2 or any("error" in r for r in res):
        fail(f"confidence screen: {res}")
    for r in res:
        check_confidence("confidence screen", r, os.path.join(out, md5[r["smiles"]]))
    log(f"[screen] confidence, --vs_batch_size 1, 2 SMILES: poses {[r['num_poses'] for r in res]}, "
        f"top-1 ranking_confidence {[round(r['confidence'][0]['ranking_confidence'], 4) for r in res]}; "
        f"head {sum(t for _, t in timer.calls):.3f} s over {sum(n for n, _ in timer.calls)} poses "
        f"(crop 256/2048), the host's metrics {timer.metrics_s:.3f} s of it")
    return runs


# ------------------------------------------------------------------- train

TRAIN_STEPS = 3


MINI_FLAGS = ["--use_mini_rollout", "--mini_rollout_steps", "12", "--alpha_pae", "1.0"]


def phase_train(torch, work, mini=False, bf16=False):
    """The train CLI at full width (with `mini`, the mini-rollout run with
    the confidence head; with `bf16`, --bf16, every launch in bf16);
    returns launches per step, seconds per step (steps 2-3) and peak
    memory."""
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.train import checkpoint as ckpt_lib
    from physdock_tpu_torch.train import train
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state

    tag = "train mini-rollout" if mini else "train bf16" if bf16 else "train"
    data = os.path.join(work, "train_data", "train_val")
    if not os.path.isdir(data):
        os.makedirs(data)
        for f in sorted(os.listdir(SYSTEMS)):
            os.symlink(os.path.join(SYSTEMS, f), os.path.join(data, f))
    out = os.path.join(work, "train_ckpt_" + tag.replace(" ", "_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_lib.reset_launches()
    t0 = time.time()
    res = train.main([
        "--dataset_dir", os.path.dirname(data), "-o", out, "--model_name", "medium",
        "--crop_size", "256", "--atom_crop_size", "2048", "--num_augmentation_sample", "48",
        "--batch_size", "1", "--total_steps", str(TRAIN_STEPS), "--save_every", str(TRAIN_STEPS),
        "--seed", "0", "--device", "cuda", *(MINI_FLAGS if mini else []),
        *(["--bf16"] if bf16 else []),
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, routes = dict(_flash_lib.LAUNCHES), dict(_flash_lib.ROUTES)
    dtypes = dict(_flash_lib.DTYPES)
    peak = torch.cuda.max_memory_allocated()
    state, model = res["state"], res["model"]
    n_params = sum(p.numel() for p in model.parameters())
    losses = [lg["loss"] for lg in res["logs"]]
    log(f"[{tag}] medium ({n_params} parameters) crop 256/2048, 48 samples"
        f"{' ' + ' '.join(MINI_FLAGS) if mini else ''}: steps {res['steps']} losses {losses} "
        f"sampler retries {res['retries']}")
    for lg in res["logs"]:
        log(f"[{tag}]   {json.dumps(lg)}")
    sec, wait = res["step_seconds"], res["wait_seconds"]
    log(f"[{tag}] seconds per step {sec} (steps 2-3 mean {sum(sec[1:]) / len(sec[1:]):.3f}), "
        f"of which waiting for the batch and its copy {wait}; peak memory allocated {peak} B "
        f"({peak / 2**30:.2f} GiB); wall {wall:.2f} s")
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    log(f"[{tag}] launches per step: {json.dumps(per_step)}; rows 5-6 by design: "
        f"{json.dumps(routes)}; by dtype {json.dumps(dtypes)}")
    if bf16 and (dtypes["float32"] or not dtypes["bfloat16"]):
        fail(f"{tag}: launches by dtype {dtypes}")
    if res["steps"] != list(range(1, TRAIN_STEPS + 1)) or not all(
            math.isfinite(v) for lg in res["logs"] for v in lg.values()):
        fail(f"{tag}: steps {res['steps']} or non-finite losses {res['logs']}")
    if mini and not all({"plddt_loss", "pae_loss", "pde_loss"} <= set(lg) for lg in res["logs"]):
        fail(f"{tag}: the confidence losses were not logged: {res['logs']}")
    if res["retries"] != 0:
        fail(f"{tag}: {res['retries']} sampler retries")
    for n in ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa"):
        if launches[n] <= 0:
            fail(f"{tag}: {n} never launched")
    check_tc_routes(tag, routes)

    t0 = time.time()
    init = load_model(None, PhysDockConfig.named("medium", num_augmentation_sample=48), seed=0,
                      with_confidence=mini)
    init_sd = init.state_dict()
    moved = {}
    for part, names in (("all", list(init_sd)),
                        ("head", [n for n in init_sd if n.startswith("confidence_module.")])):
        moved[part] = (
            sum(float((state.params[n].detach().cpu() - init_sd[n]).abs().sum()) for n in names),
            sum(float((state.ema_params[n].cpu() - init_sd[n]).abs().sum()) for n in names))
    log(f"[{tag}] sum |params - init|, sum |ema - init|: {json.dumps(moved)}")
    if not all(x > 0 for part in (("all", "head") if mini else ("all",)) for x in moved[part]):
        fail(f"{tag}: params or EMA did not move: {moved}")
    path = res["checkpoints"][-1] if res["checkpoints"] else None
    if path != ckpt_lib.latest_checkpoint(out) or not path.endswith(f"step_{TRAIN_STEPS:08d}.pt"):
        fail(f"{tag}: checkpoint {path} is not the newest step-{TRAIN_STEPS} one")
    fresh = init_train_state(init, make_optimizer())
    restored = ckpt_lib.restore_train_state(path, fresh)
    same = restored.step == TRAIN_STEPS and all(
        torch.equal(restored.params[n].detach(), state.params[n].detach().cpu())
        and torch.equal(restored.ema_params[n], state.ema_params[n].cpu())
        and torch.equal(restored.opt_state.mu[n], state.opt_state.mu[n].cpu())
        for n in state.params)
    if not same:
        fail(f"{tag}: the step-{TRAIN_STEPS} checkpoint does not restore the train state")
    npz = os.path.join(work, f"ema_params_{tag.replace(' ', '_')}.npz")
    ckpt_lib.save_params_npz(npz, state.ema_params)
    # every key used exactly once, or it raises
    counts = load_jax_params(PhysDock(model.cfg, with_confidence=mini), npz)
    if counts["unused_head_keys"]:
        fail(f"{tag}: the exported EMA left keys unused: {counts}")
    log(f"[{tag}] checkpoint {os.path.basename(path)} restores; EMA exported "
        f"({os.path.getsize(npz)} B, {counts['keys']} arrays) and loaded into a fresh model"
        f"{' with the head' if mini else ''} ({time.time() - t0:.2f} s)")
    return per_step, sum(sec[1:]) / len(sec[1:]), peak


# ------------------------------------------------------------ dp and tp

TP = 2  # ranks of the two-rank phases, sharing the one card over gloo
# the kernels at the row-shard shapes a tp=2 rank gives them (S_q = S/2
# query rows against all S_k keys): the tp dock at crop 256/2048 (rows
# 1-4) and the tp train step (rows 5-6), and ragged shards (S 200: 100
# query rows, no multiple of the kernels' 64-row tiles)
TP_FWD_SITES = [
    ("flash_sdpa_folded_v3", "tp_atom_dit", dict(layout="folded", B=20, H=4, S=2048, D=32),
     (0, 1024)),
    ("flash_sdpa_grouped", "tp_token_dit", dict(layout="heads", B=20, H=16, S=256, D=32),
     (0, 128)),
    ("flash_sdpa_grouped", "tp_msa_row", dict(layout="heads", B=2, H=8, S=256, D=32), (128, 256)),
    ("flash_sdpa_folded", "tp_triangle_end", dict(layout="folded", B=256, H=4, S=256, D=32),
     (0, 128)),
    ("flash_sdpa_folded", "tp_triangle_end_ragged", dict(layout="folded", B=200, H=4, S=200,
                                                        D=32), (100, 200)),
    ("flash_sdpa", "tp_pair_single", dict(layout="heads_single", B=1, H=16, S=256, D=32),
     (0, 128)),
]
TP_TRAIN_SITES = {
    "tp_atom_dit": (dict(layout="folded", B=48, H=4, S=2048, D=32), (0, 1024)),
    "tp_triangle": (dict(layout="folded", B=256, H=4, S=256, D=32), (0, 128)),
    "tp_triangle_ragged": (dict(layout="folded", B=200, H=4, S=200, D=32), (100, 200)),
}
DP_REL = 1e-4  # the dp=2 step's change of the state against dp=1's, by global norm
TP_REL = 1e-4  # the tp=2 trunk's s and z, and the tp=2 step's change, against tp=1
PARITY_OPT = dict(peak_lr=1e3, warmup_steps=1, eps=1.0)  # tests/test_torch_train.py


def _site_fields(rows, name, site):
    """A kernel's numbers at one site, fp32 and (prefixed) bf16."""
    return {pre + f: rows[(name, site, dt)][f]
            for dt, pre in (("float32", ""), ("bfloat16", "bf16_"))
            for f in ("max_abs_err", "ms", "before_ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms", "S_q")}


def phase_tp_kernels(torch):
    """Rows 1-6 at the tp sites, each against its plain version, timed."""
    rows = {}
    for name, site, spec, shard in TP_FWD_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            log(f"  {name} at the tp site {site} (query rows {shard[0]}..{shard[1] - 1} of "
                f"{spec['S']}):")
            r = run_kernel_case(torch, name, spec, dtype, seed=spec["B"] + spec["S"] + 3,
                                rows=shard)
            rows[(name, site, r["dtype"])] = r
    for site, (spec, shard) in TP_TRAIN_SITES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for name, r in run_train_kernel_case(torch, site, spec, dtype, rows=shard).items():
                rows[(name, site, r["dtype"])] = r
            torch.cuda.empty_cache()
    return rows


def _card_rank_setup():
    """A spawned rank's card and numerics: the one card, TF32 off."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _toy_step(torch, batch, mesh, n_aug):
    """One toy train step (committed weights, the parity optimizer of the
    CPU tests) on this rank's systems; the change of the train state, the
    logs, the launches and the peak memory."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.train import optim
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    cfg = PhysDockConfig.named("toy", inference_mode=False, num_augmentation_sample=n_aug)
    model = PhysDock(cfg.model)
    load_jax_params(model, PARAMS)
    model = model.to("cuda")
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = optim.make_optimizer(**PARITY_OPT)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, cfg.loss, ema_decay=0.5, sigma_data=cfg.model.sigma_data,
                           mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_lib.reset_launches()
    t0 = time.time()
    state, logs = step(state, arrays_to_device(batch, "cuda"), 3)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    change = {q: {n: (t[n].detach().float() - (init[n] if q in ("params", "ema") else 0)).cpu()
                  for n in init}
              for q, t in (("params", state.params), ("mu", state.opt_state.mu),
                           ("nu", state.opt_state.nu), ("ema", state.ema_params))}
    return {"change": change, "logs": logs, "launches": dict(_flash_lib.LAUNCHES),
            "routes": dict(_flash_lib.ROUTES), "peak": torch.cuda.max_memory_allocated(),
            "seconds": seconds}


def _global_rel(got, ref):
    num = math.sqrt(sum(float(((got[n] - r).double() ** 2).sum()) for n, r in ref.items()))
    den = math.sqrt(sum(float((r.double() ** 2).sum()) for r in ref.values()))
    return num / den


def dp_rank(rank, world, path):
    """The dp phase's rank: its systems of the global batch, one step."""
    from physdock_tpu_torch.parallel.mesh import make_mesh

    torch = _card_rank_setup()
    blob = torch.load(path, weights_only=False)
    n_local = len(blob["batch"]["x_gt"]) // world
    local = {k: v[rank * n_local:(rank + 1) * n_local] for k, v in blob["batch"].items()}
    return _toy_step(torch, local, make_mesh(dp=world), blob["n_aug"])


def phase_dp(torch, work):
    """NCCL at world size 1 through the train CLI, and the dp=2 toy step of
    two gloo ranks on the card against the single-process step."""
    import numpy as np

    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.parallel import mesh as mesh_lib
    from physdock_tpu_torch.parallel.launch import run_ranks
    from physdock_tpu_torch.train import train

    data = os.path.join(work, "train_data")  # phase_train's dataset of the 4 systems
    flags = ["--dataset_dir", data, "--model_name", "toy", "--crop_size", "128",
             "--atom_crop_size", "1024", "--num_augmentation_sample", "8", "--batch_size", "2",
             "--total_steps", "2", "--save_every", "2", "--seed", "0", "--device", "cuda"]
    alone = train.main(flags + ["-o", os.path.join(work, "dp_alone")])
    nccl = train.main(flags + ["-o", os.path.join(work, "dp_nccl"), "--coordinator",
                               "file://" + os.path.join(work, "nccl_rendezvous"),
                               "--num_processes", "1", "--process_id", "0"])
    if mesh_lib.distributed():
        fail("dp: the train CLI left its process group open")
    # step 1's forward is the same computation; the backward's atomic adds
    # (index_select's gradient) make later numbers differ run to run
    init = dict(load_model(None, PhysDockConfig.named("toy"), seed=0).named_parameters())
    moved = {name: {n: (res["state"].params[n].detach().cpu() - init[n].detach())
                    for n in init} for name, res in (("alone", alone), ("nccl", nccl))}
    rel = {"step1_logs": max(abs(nccl["logs"][0][k] - v) / abs(v)
                             for k, v in alone["logs"][0].items() if v),
           "step2_logs": max(abs(nccl["logs"][1][k] - v) / abs(v)
                             for k, v in alone["logs"][1].items() if v),
           "param_change": _global_rel(moved["nccl"], moved["alone"])}
    log(f"[dp] train CLI, toy crop 128/1024, batch 2, 2 steps: alone {alone['logs']} "
        f"({alone['step_seconds']} s); NCCL world 1 {nccl['logs']} ({nccl['step_seconds']} s); "
        f"rel {json.dumps(rel)}")
    if rel["step1_logs"] > 1e-6 or rel["step2_logs"] > DP_REL or rel["param_change"] > 1e-3:
        fail(f"dp: the train CLI with NCCL at world size 1 differs from the run without: {rel}")

    feats = [featurize_train(os.path.join(SYSTEMS, f), 128, 1024, seed=i)
             for i, f in enumerate(("5SAK_ZRY_A_1.pkl.gz", "5SD5_HWI_A_1.pkl.gz"))]
    batch = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    path = os.path.join(work, "dp_blob.pt")
    torch.save({"batch": batch, "n_aug": 4}, path)
    one = _toy_step(torch, batch, None, 4)
    ranks = run_ranks(dp_rank, TP, args=(path,), rdv_dir=os.path.join(work, "dp_rdv"),
                      threads=2)
    for r, res in enumerate(ranks):
        rel = {q: _global_rel(res["change"][q], one["change"][q]) for q in one["change"]}
        log(f"[dp] rank {r} of 2 (gloo, one card): logs {res['logs']}; rel to dp 1 "
            f"{json.dumps(rel)}; {res['seconds']:.3f} s; launches {json.dumps(res['launches'])}")
        if max(rel.values()) > DP_REL or any(
                abs(res["logs"][k] - v) > DP_REL * abs(v) for k, v in one["logs"].items()):
            fail(f"dp: rank {r}'s step differs from the single-process step: {rel}")
        for n in ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa"):
            if res["launches"][n] <= 0:
                fail(f"dp: rank {r} never launched {n}")
        check_tc_routes(f"dp rank {r}", res["routes"])
    log(f"[dp] single-process step {one['logs']} ({one['seconds']:.3f} s)")
    return ranks[0]["launches"]


def phase_resume(torch, work):
    """2 + 2 toy train steps through a checkpoint against 4 in one call,
    on the keyed draws: the losses bit for bit (phase 9c)."""
    import warnings

    import numpy as np

    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.nn.transformers import set_remat
    from physdock_tpu_torch.train import checkpoint as ckpt_lib
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    cfg = PhysDockConfig.named("toy", bf16=True, num_augmentation_sample=8)
    feats = featurize_train(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), 128, 1024)
    batch = arrays_to_device({k: np.asarray(v)[None] for k, v in feats.items()}, "cuda")
    ckpt_dir = os.path.join(work, "resume_ckpt")

    def run(steps, resume=None):
        model = load_model(None, cfg, seed=0).to("cuda").train()
        set_remat(model, False)
        opt = make_optimizer(1e-3, 100)
        state = init_train_state(model, opt)
        if resume:
            state = ckpt_lib.restore_train_state(resume, state)
        step = make_train_step(model, opt, cfg.loss, sigma_data=cfg.model.sigma_data)
        logs = []
        while state.step < steps:
            state, lg = step(state, batch, 0)
            logs.append(lg)
        return state, logs

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, one_call = run(4)
            first, logs_a = run(2)
            path = ckpt_lib.save_train_state(ckpt_dir, first, keep=1)
            del first
            _, logs_b = run(4, path)
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    windows = logs_a + logs_b
    log(f"[resume] 4 steps in one call: {json.dumps(one_call)}")
    log(f"[resume] 2 + 2 through {os.path.basename(path)}: {json.dumps(windows)}; "
        f"ops without a deterministic version: {nondet}")
    if windows != one_call or not all(math.isfinite(v) for lg in one_call for v in lg.values()):
        fail("resume: 2 + 2 steps through a checkpoint differ from 4 steps in one call")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_graph(torch):
    """The gate's step with each system's forward and backward replayed as
    CUDA graphs (`make_train_step(cuda_graph=True)`) against the eager
    step: 4 steps from one init under deterministic algorithms, every loss
    term and every parameter bit for bit; then the s/step of both (phase
    9d)."""
    import numpy as np

    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.nn.transformers import set_remat
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    cfg = PhysDockConfig.named("toy", bf16=True, num_augmentation_sample=8)
    feats = featurize_train(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), 128, 1024)
    batch = arrays_to_device({k: np.asarray(v)[None] for k, v in feats.items()}, "cuda")

    def run(steps, graph):
        model = load_model(None, cfg, seed=0).to("cuda").train()
        set_remat(model, False)
        opt = make_optimizer(1e-3, 100)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, cfg.loss, sigma_data=cfg.model.sigma_data,
                               cuda_graph=graph)
        logs, secs = [], []
        while state.step < steps:
            t0 = time.time()
            state, lg = step(state, batch, 0)
            secs.append(time.time() - t0)
            logs.append(lg)
        return state, logs, secs

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, eager_logs, _ = run(4, False)
        graphed, graph_logs, _ = run(4, True)
    finally:
        torch.use_deterministic_algorithms(False)
    params_equal = all(torch.equal(eager.params[n], graphed.params[n]) for n in eager.params)
    log(f"[graph] 4 eager steps: {json.dumps(eager_logs)}")
    log(f"[graph] 4 graphed steps: {json.dumps(graph_logs)}; parameters equal: {params_equal}")
    if graph_logs != eager_logs or not params_equal:
        fail("graph: the graphed step differs from the eager step")
    del eager, graphed
    timing = {}
    for graph in (False, True):
        _, _, secs = run(12, graph)
        timing["graphed" if graph else "eager"] = float(np.mean(secs[2:]))
    log(f"[graph] s/step (steps 3-12, 5SAK alone, one process): {json.dumps(timing)}")


def _tp_dock(torch, out, tp):
    """The main dock's system and settings through DockingPipeline with
    SamplerSettings(tp=tp), featurized in process."""
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings
    from physdock_tpu_torch.ops import _flash_lib

    feats = os.path.join(REPO, "demo", "redocking", "features")
    cfg = PhysDockConfig.named("toy", crop_size=256, atom_crop_size=2048,
                               infer_pocket_cutoff=6.0, infer_use_pocket=True,
                               infer_use_key_res=True)
    featurizer = SystemFeaturizer(
        cfg.data, msa_features_dir=os.path.join(feats, "msa_features"),
        uniprot_msa_features_dir=os.path.join(feats, "uniprot_msa_features"),
        inference_mode=True, seed=0)
    settings = SamplerSettings(max_samples=40, num_samples_per_round=20, max_rounds=2, steps=40,
                               enable_physics_correction=True, num_confs=64,
                               enable_ranking=True, seed=0, tp=tp)
    pipe = DockingPipeline(cfg, load_model(PARAMS, cfg), featurizer, settings, device="cuda")
    torch.cuda.synchronize()
    _flash_lib.reset_launches()
    t0 = time.time()
    r = pipe.dock(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), out)
    torch.cuda.synchronize()
    return {"top5_rmsd": r["top5_rmsd"], "all_rmsd": r["all_rmsd"], "rounds": r["rounds"],
            "wall": time.time() - t0, "launches": dict(_flash_lib.LAUNCHES),
            "wrote": sorted(os.listdir(out)) if os.path.isdir(out) else []}


def _trunk(torch, batch):
    """The toy trunk's (s, z) at the main dock's shapes, its peak memory
    and launches."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.ops import _flash_lib

    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, PARAMS)
    model = model.to("cuda").eval()
    b = arrays_to_device(batch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _flash_lib.reset_launches()
    with torch.no_grad():
        _, _, s, z = model.conditioning(b)
    torch.cuda.synchronize()
    return {"s": s.float().cpu(), "z": z.float().cpu(), "launches": dict(_flash_lib.LAUNCHES),
            "peak_above_weights": torch.cuda.max_memory_allocated() - base}


def tp_rank(rank, world, path, work):
    """The tp phase's rank: the trunk, one train step and the dock, each
    with the pair rows sharded over the world."""
    from physdock_tpu_torch.ops import attention
    from physdock_tpu_torch.parallel.mesh import make_mesh
    from physdock_tpu_torch.parallel.tp import use_tp

    torch = _card_rank_setup()
    blob = torch.load(path, weights_only=False)
    mesh = make_mesh(tp=world)
    attention.TP_FLASH_CALLS[0] = 0
    with use_tp(mesh):
        trunk = _trunk(torch, blob["trunk_batch"])
    trunk["tp_flash_calls"] = attention.TP_FLASH_CALLS[0]
    step = _toy_step(torch, blob["train_batch"], mesh, 4)
    out = os.path.join(work, f"tp_dock_rank{rank}")
    dock_res = _tp_dock(torch, out, world)
    return {"trunk": trunk, "step": step, "dock": dock_res}


def phase_tp(torch, work):
    """Two gloo ranks on the card with the pair rows sharded (tp=2): the
    toy trunk's s and z at crop 256/2048, one toy train step, and the main
    dock through SamplerSettings(tp=2), each against tp=1."""
    import numpy as np

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.parallel.launch import run_ranks

    cfg = PhysDockConfig.named("toy", crop_size=256, atom_crop_size=2048,
                               infer_pocket_cutoff=6.0, infer_use_pocket=True,
                               infer_use_key_res=True)
    feats_dir = os.path.join(REPO, "demo", "redocking", "features")
    trunk_batch, _ = SystemFeaturizer(
        cfg.data, msa_features_dir=os.path.join(feats_dir, "msa_features"),
        uniprot_msa_features_dir=os.path.join(feats_dir, "uniprot_msa_features"),
        inference_mode=True, seed=0).load(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"))
    trunk_batch = {k: np.asarray(v) for k, v in trunk_batch.items()}
    train_feats = featurize_train(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), 128, 1024)
    train_batch = {k: np.asarray(v)[None] for k, v in train_feats.items()}
    path = os.path.join(work, "tp_blob.pt")
    torch.save({"trunk_batch": trunk_batch, "train_batch": train_batch}, path)

    one_trunk = _trunk(torch, trunk_batch)
    one_step = _toy_step(torch, train_batch, None, 4)
    one_dock = _tp_dock(torch, os.path.join(work, "tp_dock_one"), 1)
    ranks = run_ranks(tp_rank, TP, args=(path, work), rdv_dir=os.path.join(work, "tp_rdv"),
                      threads=2)
    for r, res in enumerate(ranks):
        tr, st, dk = res["trunk"], res["step"], res["dock"]
        rel = {k: float((tr[k] - one_trunk[k]).abs().max() / one_trunk[k].abs().max())
               for k in ("s", "z")}
        step_rel = {q: _global_rel(st["change"][q], one_step["change"][q])
                    for q in one_step["change"]}
        log(f"[tp] rank {r} of 2 (gloo, one card): trunk s/z rel to tp 1 {json.dumps(rel)}; "
            f"peak above the weights {tr['peak_above_weights']} B (tp 1: "
            f"{one_trunk['peak_above_weights']} B); row-sharded attention calls "
            f"{tr['tp_flash_calls']}; trunk launches {json.dumps(tr['launches'])}")
        log(f"[tp] rank {r} train step: rel to tp 1 {json.dumps(step_rel)}; logs {st['logs']} "
            f"(tp 1: {one_step['logs']}); {st['seconds']:.3f} s (tp 1: "
            f"{one_step['seconds']:.3f} s); peak {st['peak']} B (tp 1: {one_step['peak']} B); "
            f"launches {json.dumps(st['launches'])}")
        log(f"[tp] rank {r} dock (SamplerSettings(tp=2)): top5 {dk['top5_rmsd']} (tp 1: "
            f"{one_dock['top5_rmsd']}); {dk['wall']:.2f} s (tp 1: {one_dock['wall']:.2f} s); "
            f"launches {json.dumps(dk['launches'])}; wrote {len(dk['wrote'])} files")
        if max(rel.values()) > TP_REL or max(step_rel.values()) > TP_REL:
            fail(f"tp: rank {r} differs from tp 1: trunk {rel}, step {step_rel}")
        if tr["tp_flash_calls"] <= 0:
            fail(f"tp: rank {r}'s trunk never took the row-sharded attention route")
        check_tc_routes(f"tp rank {r} train step", st["routes"])
        for n in ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa"):
            if st["launches"][n] <= 0:
                fail(f"tp: rank {r}'s train step never launched {n}")
        missing = [k for k, _, _ in kernel_cases() if dk["launches"][k] <= 0]
        if missing:
            fail(f"tp: rank {r}'s dock never launched {missing}")
        top = dk["top5_rmsd"][0]
        if not (abs(top - MAIN_RMSD_REF) <= MAIN_RMSD_TOL
                and all(math.isfinite(x) for x in dk["all_rmsd"])):
            fail(f"tp: rank {r}'s top-ranked RMSD {top} A is not within {MAIN_RMSD_TOL} A of "
                 f"{MAIN_RMSD_REF} A")
        if (r == 0) != bool(dk["wrote"]):
            fail(f"tp: rank {r} wrote {dk['wrote']}: rank 0 alone writes")
    if ranks[0]["dock"]["all_rmsd"] != ranks[1]["dock"]["all_rmsd"]:
        fail("tp: the two ranks' docks differ")
    return ranks[0], one_trunk, one_step, one_dock


# -------------------------------------------------------------------- main


# --------------------------------------------------------------- native, demo


def phase_native(torch, poses, meta):
    """The native host library built here and held to its NumPy versions
    on the demo ligands, 20 main-dock poses and an A3M written from the
    demo MSA features, with each one's time."""
    import numpy as np

    from physdock_tpu_torch import native
    from physdock_tpu_torch.data.msa.search import int8_to_a3m
    from physdock_tpu_torch.data.smiles import mol_from_smiles
    from physdock_tpu_torch.utils.io import load_pkl

    t0 = time.time()
    native.build(force=True)
    log(f"[native] g++ {native.SOURCE} -> {native.lib_path()} {time.time() - t0:.2f} s")
    times = {}

    def both(name, fn, fn_np, *args):
        t = time.perf_counter()
        got = fn(*args)
        t_nat = time.perf_counter() - t
        t = time.perf_counter()
        want = fn_np(*args)
        times[name] = times.get(name, [0.0, 0.0])
        times[name][0] += t_nat
        times[name][1] += time.perf_counter() - t
        return got, want

    with open(os.path.join(SCREEN, "demo_db.txt")) as f:
        smiles = [ln.strip() for ln in f if ln.strip()]
    n_bonds = 0
    for smi in smiles:
        mol = mol_from_smiles(smi, embed=True, seed=0)
        pos, z = np.asarray(mol.coords, np.float32), np.asarray(mol.atomic_numbers, np.int32)
        for scale in (1.17, 1.25):
            got, want = both("perceive_bonds", native.perceive_bonds, native.perceive_bonds_np,
                             pos, z, scale)
            if got != want:
                fail(f"native perceive_bonds differs from NumPy on {smi} at scale {scale}")
            n_bonds += len(got)
    # float64 sums in the library, float32 in NumPy: relative to the largest value
    lig = poses[:20][:, np.asarray(meta["ligand_atom_idx"])]
    got, want = both("pairwise_rmsd", native.pairwise_rmsd, native.pairwise_rmsd_np, lig)
    err_rmsd = float(np.abs(got - want).max() / np.abs(want).max())
    got, want = both("conformer_dist_bank", native.conformer_dist_bank,
                     native.conformer_dist_bank_np, lig)
    err_bank = float(np.abs(got - want).max() / np.abs(want).max())
    if not (err_rmsd <= 1e-5 and err_bank <= 1e-5):
        fail(f"native pose geometry differs from NumPy: rmsd {err_rmsd}, bank {err_bank} "
             f"(relative to the largest value)")
    feats = load_pkl(sorted(glob.glob(os.path.join(
        REPO, "demo", "redocking", "features", "msa_features", "*.pkl.gz")))[0])
    text = int8_to_a3m(feats["msa"], feats["deletion_matrix"])
    (m, d), (m_np, d_np) = both("a3m_parse", native.parse_a3m_int8, native.parse_a3m_int8_np,
                                text)
    # two rows of this file hold negative (wrapped int8) deletion counts,
    # which the A3M writes as no insertion
    if not ((m == m_np).all() and (d == d_np).all() and (m == feats["msa"]).all()
            and (d == np.maximum(feats["deletion_matrix"], 0)).all()):
        fail("native A3M parse differs from NumPy or from the features it was written from")
    log("[native] " + json.dumps({
        "ligands": len(smiles), "bonds": n_bonds, "poses": list(lig.shape),
        "rmsd_max_rel_err": err_rmsd, "bank_max_rel_err": err_bank,
        "a3m_rows": int(m.shape[0]), "a3m_cols": int(m.shape[1]),
        "seconds_native_numpy": {k: [round(a, 5), round(b, 5)] for k, (a, b) in times.items()}}))


def phase_demo(torch, work):
    """The self-contained demo complex built on the host, then redocked by
    the port's CLI on the card at the JAX demo test's settings."""
    from physdock_tpu_torch.cli import redocking
    from physdock_tpu_torch.data.demo import make_demo_complex
    from physdock_tpu_torch.data.mol import read_sdf
    from physdock_tpu_torch.data.parsers import parse_pdb

    t0 = time.time()
    pkl = make_demo_complex(os.path.join(work, "demo_in"))
    t_make = time.time() - t0
    out = os.path.join(work, "demo_out")
    t0 = time.time()
    res = redocking.main([
        "-i", pkl, "-o", out, "--params", PARAMS, "--model_name", "toy",
        "--crop_size", "64", "--atom_crop_size", "256", "--steps", "3", "--max_rounds", "2",
        "--num_samples_per_round", "2", "--max_samples", "2", "--num_confs", "4",
        "--enable_physics_correction", "--enable_ranking", "--device", "cuda"])
    t_dock = time.time() - t0
    if len(res) != 1 or "error" in res[0]:
        fail(f"demo dock failed: {res}")
    top5 = res[0]["top5_rmsd"]
    if not top5 or not all(math.isfinite(x) for x in top5):
        fail(f"demo dock gave no finite RMSDs: {top5}")
    sysdir = os.path.join(out, str(res[0]["system_id"]))
    chains = parse_pdb(os.path.join(sysdir, "pred_rank0.pdb"))
    n_lig = read_sdf(os.path.join(sysdir, "ligand_rank0.sdf")).num_atoms
    if not ("A" in chains and "B" in chains and n_lig == 11):
        fail(f"demo outputs: chains {sorted(chains)}, ligand atoms {n_lig}")
    log(f"[demo] built in {t_make:.2f} s; docked on the card in {t_dock:.2f} s: top5_rmsd "
        f"{top5}, chains {sorted(chains)}, {n_lig} ligand atoms")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr, flush=True)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "physdock_tpu_torch")):
        print("chip_smoke: physdock_tpu_torch/ is not beside this script", file=sys.stderr, flush=True)
        sys.exit(2)
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    t0 = time.time()
    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()} ({time.time() - t0:.2f} s)")

    from physdock_tpu_torch.ops import _flash_lib

    t0 = time.time()
    _flash_lib.build_all(force=True)
    for name, blog in _flash_lib.BUILD_LOG.items():
        log(f"[build] nvcc {name}.cu {blog['seconds']:.2f} s")
        for line in blog["ptxas"].splitlines():
            if "ptxas" in line or "spill" in line or "Used" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] done, both sources in parallel ({time.time() - t0:.2f} s)")
    check_sass()

    t0 = time.time()
    rows = phase_kernels(torch)
    log(f"[kernels] 4 wrappers x 2 dtypes, and the batched screen's and redock's sites, match "
        f"their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    train_rows = phase_train_kernels(torch)
    log(f"[train_kernels] rows 2 and 4 at {len(TRAIN_FWD_SITES)} training sites and rows 5-6 "
        f"at 2 sites, x 2 dtypes, match their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    conf_rows = phase_conf_kernels(torch)
    log(f"[conf_kernels] rows 3 and 4 at the confidence head's {len(CONF_SITES)} dock sites, "
        f"x 2 dtypes, match their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    tp_rows = phase_tp_kernels(torch)
    log(f"[tp_kernels] rows 1-4 at {len(TP_FWD_SITES)} and rows 5-6 at {len(TP_TRAIN_SITES)} "
        f"row-shard sites, x 2 dtypes, match their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_model(torch)
    log(f"[model] card matches the CPU at crop 256/2048 ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_recycle(torch)
    log(f"[recycle] card matches the CPU with one recycle ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_grad(torch)
    log(f"[grad] card matches the CPU for one training step, and bf16 the fp32 step "
        f"({time.time() - t0:.2f} s)")

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    t0 = time.time()
    _flash_lib.reset_launches()
    tops, acc_results, many_s, check_s = phase_accuracy(torch, work)
    acc_launches = dict(_flash_lib.LAUNCHES)
    t_acc = time.time() - t0
    log(f"[accuracy] top-ranked RMSD (A): {json.dumps(tops)}")
    log(f"[accuracy] launches: {json.dumps(acc_launches)} ({t_acc:.2f} s)")
    bad = {k: v for k, v in tops.items() if not (v < 2.0)}
    if bad:
        fail(f"accuracy dock: top-ranked RMSD >= 2 A: {bad}")
    missing = [k for k, _, _ in kernel_cases() if k != "flash_sdpa_folded_v3"
               and acc_launches[k] <= 0]
    if missing:  # the atom DiT takes row 3 below 1024 atoms
        fail(f"accuracy dock (dock_many) never launched {missing}")

    t0 = time.time()
    phase_accuracy_bf16(torch, work, tops)
    log(f"[accuracy bf16] done ({time.time() - t0:.2f} s)")

    t0 = time.time()
    batched_launches = phase_redock_many(torch, work, card, acc_results, many_s, check_s)
    log(f"[redock_many] done ({time.time() - t0:.2f} s)")

    t0 = time.time()
    conf_tops, conf_launches, head_launches = phase_confidence(torch, work)
    log(f"[confidence] confidence-ranked top-1 RMSD (A): {json.dumps(conf_tops)} "
        f"({time.time() - t0:.2f} s)")

    torch.cuda.synchronize()
    _flash_lib.reset_launches()
    t0 = time.time()
    res, (main_poses, main_meta) = phase_main(work)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_flash_lib.LAUNCHES)
    if len(res) != 1 or not res[0].get("top5_rmsd") or not all(
            math.isfinite(x) for x in res[0]["all_rmsd"]):
        fail(f"main dock gave no finite poses: {res}")
    poses = 20 * res[0]["rounds"]
    log(f"[main] {res[0]['system_id']} crop 256/2048: rounds {res[0]['rounds']} "
        f"top5_rmsd {res[0]['top5_rmsd']} wall {wall:.2f} s, {poses / wall:.3f} poses/s "
        f"({card})")
    log(f"[main] timings (s): {json.dumps(res[0]['timings'])}, dock total {res[0]['total_time_s']}")
    log(f"[main] launches: {json.dumps(launches)}")
    missing = [k for k, _, _ in kernel_cases() if launches[k] <= 0]
    if missing:
        fail(f"main path never launched: {missing}")
    top = res[0]["top5_rmsd"][0]
    if not abs(top - MAIN_RMSD_REF) <= MAIN_RMSD_TOL:
        fail(f"main dock top-ranked RMSD {top} A is not within {MAIN_RMSD_TOL} A "
             f"of the CPU reading {MAIN_RMSD_REF} A")

    t0 = time.time()
    phase_native(torch, main_poses, main_meta)
    log(f"[native] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_demo(torch, work)
    log(f"[demo] done ({time.time() - t0:.2f} s)")

    t0 = time.time()
    per_step, sec32, peak32 = phase_train(torch, work)
    log(f"[train] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    _, sec16, peak16 = phase_train(torch, work, bf16=True)
    log(f"[train bf16] s/step (steps 2-3) bf16 {sec16:.3f} fp32 {sec32:.3f}; peak memory "
        f"allocated bf16 {peak16} B ({peak16 / 2**30:.2f} GiB) fp32 {peak32} B "
        f"({peak32 / 2**30:.2f} GiB) ({time.time() - t0:.2f} s; {card})")
    t0 = time.time()
    mini_per_step, _, _ = phase_train(torch, work, mini=True)
    log(f"[train mini-rollout] done ({time.time() - t0:.2f} s)")

    t0 = time.time()
    dp_launches = phase_dp(torch, work)
    log(f"[dp] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_resume(torch, work)
    log(f"[resume] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_graph(torch)
    log(f"[graph] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    tp_rank0, _, _, _ = phase_tp(torch, work)
    tp_train_launches = tp_rank0["step"]["launches"]
    tp_dock_launches = tp_rank0["dock"]["launches"]
    log(f"[tp] done ({time.time() - t0:.2f} s; {card})")

    t0 = time.time()
    phase_lockstep(torch)
    log(f"[lockstep] done ({time.time() - t0:.2f} s)")
    t0 = time.time()
    screen_launches = phase_screen(torch, work, card)
    log(f"[screen] done ({time.time() - t0:.2f} s)")

    kernels = []
    for name, replaces, _ in kernel_cases():
        r, rb = rows[(name, "float32")], rows[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "physdock_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "before_ms": r["before_ms"],
            "bf16_max_abs_err": rb["max_abs_err"], "bf16_ms": rb["ms"],
            "bf16_bound_ms": rb["bound_ms"], "bf16_bound_by": rb["bound_by"],
            "bf16_library_ms": rb["library_ms"], "bf16_before_ms": rb["before_ms"],
            "train_launches_per_step": per_step[name],
            "train_sites": {
                site: {k: train_rows[(n, site, dt)][f]
                       for dt, pre in (("float32", ""), ("bfloat16", "bf16_"))
                       for f, k in (("max_abs_err", pre + "max_abs_err"), ("ms", pre + "ms"),
                                    ("before_ms", pre + "before_ms"), ("plain_ms", pre + "plain_ms"),
                                    ("bound_ms", pre + "bound_ms"), ("bound_by", pre + "bound_by"),
                                    ("library_ms", pre + "library_ms"))}
                for n, site, _ in TRAIN_FWD_SITES if n == name},
            "screen_launches": {f"vs{bs}": n[name] for bs, n in screen_launches.items()},
            "redock_many_launches": {"dock_many": acc_launches[name],
                                     "dock_batch_size_4": batched_launches[name]},
            "confidence_dock_launches": conf_launches[name],
            "confidence_head_launches": head_launches[name],
            "mini_rollout_launches_per_step": mini_per_step[name],
            "confidence_sites": {
                site: {k: conf_rows[(n, site, dt)][f]
                       for dt, pre in (("float32", ""), ("bfloat16", "bf16_"))
                       for f, k in (("max_abs_err", pre + "max_abs_err"), ("ms", pre + "ms"),
                                    ("before_ms", pre + "before_ms"), ("plain_ms", pre + "plain_ms"),
                                    ("bound_ms", pre + "bound_ms"), ("bound_by", pre + "bound_by"),
                                    ("library_ms", pre + "library_ms"))}
                for n, site, _ in CONF_SITES if n == name},
            "tp_sites": {site: _site_fields(tp_rows, n, site)
                         for n, site, _, _ in TP_FWD_SITES if n == name},
            "tp_dock_launches": tp_dock_launches[name],
            "tp_train_launches": tp_train_launches[name],
            "dp_train_launches": dp_launches[name],
        })
        for tag, (site_name, _) in (("screen", SCREEN_SITE), ("redock", REDOCK_SITE)):
            if name == site_name:
                kernels[-1][f"{tag}_site"] = {
                    k: rows[(name, tag, dt)][f]
                    for dt, pre in (("float32", ""), ("bfloat16", "bf16_"))
                    for f, k in (("max_abs_err", pre + "max_abs_err"), ("ms", pre + "ms"),
                                 ("before_ms", pre + "before_ms"), ("plain_ms", pre + "plain_ms"),
                                 ("bound_ms", pre + "bound_ms"), ("bound_by", pre + "bound_by"),
                                 ("library_ms", pre + "library_ms"), ("lead", pre + "lead"))}
    for name, replaces, source in TRAIN_KERNELS:
        r = train_rows[(name, "atom_dit", "float32")]
        rb = train_rows[(name, "atom_dit", "bfloat16")]
        rt = train_rows[(name, "triangle", "float32")]
        rtb = train_rows[(name, "triangle", "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(per_step[name] * TRAIN_STEPS),
            "max_abs_err": max(x["max_abs_err"] for x in (r, rt)),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "before_ms": r["before_ms"],
            "bf16_max_abs_err": max(x["max_abs_err"] for x in (rb, rtb)), "bf16_ms": rb["ms"],
            "bf16_bound_ms": rb["bound_ms"], "bf16_bound_by": rb["bound_by"],
            "bf16_library_ms": rb["library_ms"], "bf16_before_ms": rb["before_ms"],
            "train_sites": {"triangle": {
                k: rr[f] for rr, pre in ((rt, ""), (rtb, "bf16_"))
                for f, k in (("max_abs_err", pre + "max_abs_err"), ("ms", pre + "ms"),
                             ("before_ms", pre + "before_ms"), ("plain_ms", pre + "plain_ms"),
                             ("bound_ms", pre + "bound_ms"), ("bound_by", pre + "bound_by"),
                             ("library_ms", pre + "library_ms"))}},
            "train_launches_per_step": per_step[name],
            "confidence_dock_launches": conf_launches[name],
            "confidence_head_launches": head_launches[name],
            "mini_rollout_launches_per_step": mini_per_step[name],
            "tp_sites": {site: _site_fields(tp_rows, name, site) for site in TP_TRAIN_SITES},
            "tp_dock_launches": tp_dock_launches[name],
            "tp_train_launches": tp_train_launches[name],
            "dp_train_launches": dp_launches[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(f"[summary] wall {time.time() - t_all:.2f} s (the run before the confidence phases: "
        f"{EARLIER_WALL_S} s)")
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
