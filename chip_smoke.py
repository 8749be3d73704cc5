#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`physdock_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card

Phases, each printing its result and seconds on flushed lines; any failure
exits non-zero (no phase is caught):

  1. device   -- nvidia-smi name and power limit, torch and CUDA versions
  2. build    -- nvcc of csrc/flash_fwd.cu and csrc/flash_bwd.cu, one
                 process each, started together, with the -Xptxas -v reports
  3. kernels  -- each of the four forward attention wrappers at its
                 call-site shape, fp32 and bf16, masked rows and the -2e9
                 tier included, against its plain PyTorch version (fp32
                 <= 1e-4 with TF32 off, bf16 <= 2e-2); kernel, plain and
                 SDPA times
  4. kernels (training) -- the kernels at the shapes and strides the
                 medium train run gives them (crop 256/2048, 48 samples):
                 flash_sdpa_grouped at the token DiT (B 48, H 16, S 256,
                 D 32) and the MSA rows (B 2, H 8), flash_sdpa at the
                 Pairformer single attention (H 16, S 256), the trunk
                 atom transformer (H 4, S 2048) and the MSA columns (no
                 bias), each against its plain version at phase 3's
                 limits; flash_fwd_lse and flash_bwd at their two call
                 sites (atom DiT: B 48, H 4, S 2048, D 32; triangle:
                 B 256, H 4, S 256, D 32): o, m, l, dq, dk, dv and dbias
                 against the plain versions (rel to max|plain|: fp32 1e-4,
                 bf16 2e-2); all fp32 and bf16 with masked rows and the
                 -2e9 tier; kernel, plain and SDPA times (for rows 5-6 the
                 memory-efficient SDPA forward, backward alone, the bias
                 expanded over B and requiring grad)
  5. model    -- the toy model's conditioning, DiT bias cache and denoise
                 at the main dock's shapes (256 tokens, 2048 atoms, 2
                 samples), on the card through the kernels and on the CPU
                 through their plain versions; every output within rel
                 1e-3 of max|cpu| (fp32, TF32 off), and every forward
                 wrapper, the atom DiT's v3 included, launched
  6. grad     -- one training step's loss and gradient of the toy model
                 (committed weights) on 5SAK_ZRY_A_1 featurized in training
                 mode at crop 128/1024 with 4 augmentation samples, the
                 noise drawn from one CPU generator: on the card through
                 the kernels and on the CPU through the plain versions;
                 loss within rel 1e-4, ||g_card - g_cpu|| <= 1e-3 ||g_cpu||
                 over all parameters; rows 5, 6, 2 and 4 launched, rows 1
                 and 3 not (the dispatch under grad)
  7. accuracy -- guided redocking of the 4 demo systems with the committed
                 toy weights (_overfit/ema_params.npz) at crop 128/1024,
                 40 steps, 2 rounds, 20 poses per round, fp32; every
                 top-ranked ligand RMSD must be < 2 A
  8. main     -- one demo system at crop 256/2048 (20 poses per round):
                 launch counters reset before and read after; every
                 forward wrapper must have launched, and the top-ranked
                 RMSD must lie within 0.5 A of the CPU reading of both
                 packages
  9. train    -- the train CLI in process at full width: the medium preset
                 (random weights from a seed), crop 256/2048, 48
                 augmentation samples, 3 steps of one system, fp32, on a
                 dataset of the 4 demo systems; every loss finite, no
                 sampler retry, params and EMA moved, the step-3
                 checkpoint restores and its EMA exports as the JAX .npz
                 layout that loads into a fresh model with every key used
                 once; seconds per step (the wait for the batch and its
                 copy included, and also shown alone), peak memory,
                 launches per step
 10. summary  -- the per-kernel JSON line (six rows; launches from the
                 main dock for rows 1-4 and from the train run for rows
                 5-6), the card line, and last the {"ok": true, ...} line

It imports nothing of JAX, starts no process other than nvcc and
nvidia-smi (the train run's prefetch is a thread, stopped when it ends),
and exits non-zero without a result when CUDA is absent or the port's
package is not beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SYSTEMS = os.path.join(REPO, "demo", "redocking", "Posebusters_subset")
H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PARAMS = os.path.join(REPO, "_overfit", "ema_params.npz")
MODEL_REL = 1e-3
# 5SAK_ZRY_A_1 at crop 256/2048 with the toy weights, which were trained at
# crop 128/1024 only: the JAX CLI on the CPU gives a top-ranked 4.34-4.38 A
# and the port on the CPU 4.34-4.37 A. A wrong kernel lands poses far off.
MAIN_RMSD_REF, MAIN_RMSD_TOL = 4.36, 0.5


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


def heads_view(x, layout, H):
    """The [..., H, S, D] view the attention modules pass: heads split
    from [B, S, H*D] ("heads") or [S, H*D] ("heads_single"). Other
    layouts are returned as they are."""
    if layout in ("heads", "heads_single"):
        return x.unflatten(-1, (H, -1)).transpose(-3, -2)
    return x


def make_inputs(torch, spec, dtype, seed):
    """q/k/v in the call site's layout and a [H, S, S] bias with the two
    mask tiers: random keys at -1e9, whole rows at -1e9 (fully masked),
    and the last eighth of the keys at -2e9 on top (pad tier); no bias
    where the site has none (`bias=False`)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, H, S, D = spec["B"], spec["H"], spec["S"], spec["D"]
    layout = spec["layout"]
    shape = {"folded": (B, S, H * D), "split": (B, H, S, D), "single": (H, S, D),
             "heads": (B, S, H * D), "heads_single": (S, H * D)}[layout]
    q, k, v = (heads_view(torch.randn(shape, generator=g, device="cuda").to(dtype), layout, H)
               for _ in range(3))
    if not spec.get("bias", True):
        return q, k, v, None
    bias = torch.randn((H, S, S), generator=g, device="cuda")
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


def run_kernel_case(torch, name, spec, dtype, seed=None):
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
    if spec["layout"] == "folded":
        wrapper = flash_sdpa_folded_v3 if name == "flash_sdpa_folded_v3" else flash_sdpa_folded
        kern = lambda: wrapper(q, k, v, bias, H)  # noqa: E731
        qs, ks, vs = (split_view(x, H) for x in (q, k, v))
        plain = lambda: _flash_lib.sdpa_plain(qs, ks, vs, bias)  # noqa: E731
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
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask_b)  # noqa: E731
    reps = 20 if spec["S"] >= 2048 else 50
    ms = time_ms(torch, kern, reps)
    plain_ms = time_ms(torch, plain, max(3, reps // 5))
    library_ms = time_ms(torch, lib, reps)
    B, S, D = spec["B"], spec["S"], spec["D"]
    isz = torch.tensor([], dtype=dtype).element_size()
    # q, k, v, o, bias once each
    nbytes = (4 * B * H * S * D + (0 if bias is None else H * S * S)) * isz
    flops = 4 * B * H * S * S * D
    dname = str(dtype).replace("torch.", "")
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dname] * 1e3
    row = {
        "name": name, "dtype": dname, "max_abs_err": err, "finite": finite,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": {k: spec[k] for k in ("B", "H", "S", "D")}, "layout": spec["layout"],
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


def _rel(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def run_train_kernel_case(torch, site, spec, dtype):
    """Rows 5 and 6 at one call site against their plain versions, with
    the memory-efficient SDPA as the yardstick."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from physdock_tpu_torch.ops.flash_attention_bwd import (
        flash_bwd,
        flash_bwd_plain,
        flash_fwd_lse,
        flash_fwd_lse_plain,
    )
    from physdock_tpu_torch.ops.flash_attention_folded import split_view

    B, H, S, D = spec["B"], spec["H"], spec["S"], spec["D"]
    q, k, v, bias = make_inputs(torch, spec, dtype, seed=S + B)
    q, k, v = (split_view(x, H) for x in (q, k, v))  # [B, H, S, D] views, folded strides
    g = torch.Generator(device="cuda").manual_seed(B)
    do = split_view(torch.randn((B, S, H * D), generator=g, device="cuda").to(dtype), H)

    o, m, l = flash_fwd_lse(q, k, v, bias)
    grads = flash_bwd(q, k, v, bias, o, m, l, do)
    torch.cuda.synchronize()
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
    big = S >= 2048
    t = {"fwd": time_ms(torch, fwd, 5 if big else 20), "bwd": time_ms(torch, bwd, 3 if big else 10),
         "plain_fwd": time_ms(torch, plain_fwd, 2 if big else 5),
         "plain_bwd": time_ms(torch, plain_bwd, 2 if big else 5)}
    # yardstick: memory-efficient SDPA with the bias expanded over B, all
    # inputs requiring grad; timed only, never on the port's path
    lq, lk, lv = (x.detach().requires_grad_(True) for x in (q, k, v))
    lb = bias.to(dtype).detach().requires_grad_(True)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        run = lambda: F.scaled_dot_product_attention(  # noqa: E731
            lq, lk, lv, attn_mask=lb.expand(B, H, S, S))
        with torch.no_grad():
            t["sdpa_fwd"] = time_ms(torch, run, 5 if big else 20)
        out = run()
        t["sdpa_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (lq, lk, lv, lb), do, retain_graph=True), 3 if big else 10)
        t["sdpa_fwd_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            run(), (lq, lk, lv, lb), do), 3 if big else 10)
    del out

    isz = torch.tensor([], dtype=dtype).element_size()
    bhsd = B * H * S * D
    peak = PEAK_FLOPS[dname]
    rows = {}
    for name, nbytes, flops, ms, plain_ms, lib_ms, err, abs_err in (
        # q, k, v, bias read; o written; m, l fp32 written
        ("flash_fwd_lse", (4 * bhsd + H * S * S) * isz + 2 * B * H * S * 4,
         4 * B * H * S * S * D, t["fwd"], t["plain_fwd"], t["sdpa_fwd"],
         max(errs[n] for n in ("o", "m", "l")), abs_fwd),
        # q, k, v, o, do, bias read, m, l read; dq, dk, dv, dbias (fp32)
        # written; five products (s recomputed, dp, dv, dq, dk)
        ("flash_bwd", (8 * bhsd + H * S * S) * isz + 2 * B * H * S * 4 + H * S * S * 4,
         10 * B * H * S * S * D, t["bwd"], t["plain_bwd"], t["sdpa_bwd"],
         max(errs[n] for n in ("dq", "dk", "dv", "dbias")), abs_bwd),
    ):
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
        rows[name] = {
            "name": name, "site": site, "dtype": dname, "max_rel_err": err, "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    log(f"  {site} {dname} errs {json.dumps(errs)} times {json.dumps(t)} finite {finite}")
    for r in rows.values():
        log(f"  {json.dumps(r)}")
    bad = {n: e for n, e in errs.items() if not e <= TOL[dname]}
    if bad or not finite:
        fail(f"training kernels at {site} {dname}: rel err over {TOL[dname]}: {bad} "
             f"(finite={finite})")
    return rows


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


def train_loss_and_grads(torch, feats, device, n_aug=4, seed=0):
    """Loss, loss terms and every parameter's gradient of one training
    forward of the toy model with the committed weights on `device`."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.infer.pipeline import arrays_to_device
    from physdock_tpu_torch.model.losses import physdock_loss
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params

    cfg = PhysDockConfig.named("toy", inference_mode=False, num_augmentation_sample=n_aug)
    model = PhysDock(cfg.model)
    load_jax_params(model, PARAMS)
    model = model.to(device)
    batch = arrays_to_device(feats, device)
    out = model(batch, torch.Generator().manual_seed(seed))
    loss, logs = physdock_loss(out, batch, cfg.loss, sigma_data=cfg.model.sigma_data)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
             for (n, p), g in zip(named, grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in logs.items()}, grads


def phase_grad(torch):
    from physdock_tpu_torch.ops import _flash_lib

    feats = featurize_train(os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz"), 128, 1024)
    _flash_lib.reset_launches()
    card = train_loss_and_grads(torch, feats, "cuda")
    torch.cuda.synchronize()
    launches = dict(_flash_lib.LAUNCHES)
    cpu = train_loss_and_grads(torch, feats, "cpu")
    diff = math.sqrt(sum(float(((card[2][n] - g) ** 2).sum()) for n, g in cpu[2].items()))
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in cpu[2].values()))
    worst = max((float((card[2][n] - g).norm() / g.norm()), n)
                for n, g in cpu[2].items() if float(g.norm()) > 1e-8)
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    log(f"[grad] loss card {card[0]!r} cpu {cpu[0]!r} (rel {loss_rel:.3e}); terms card "
        f"{json.dumps(card[1])} cpu {json.dumps(cpu[1])}")
    log(f"[grad] ||g_card - g_cpu|| / ||g_cpu|| = {diff / norm:.3e} over {len(cpu[2])} tensors "
        f"(||g_cpu|| {norm:.4f}); worst tensor {worst[1]} rel {worst[0]:.3e}")
    log(f"[grad] launches: {json.dumps(launches)}")
    if not (math.isfinite(card[0]) and loss_rel <= GRAD_REL_LOSS):
        fail(f"grad: card loss {card[0]} vs cpu {cpu[0]} (rel {loss_rel}) over {GRAD_REL_LOSS}")
    if not diff <= GRAD_REL * norm:
        fail(f"grad: ||g_card - g_cpu|| {diff} > {GRAD_REL} * ||g_cpu|| {norm}")
    want = ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa")
    missing = [n for n in want if launches[n] <= 0]
    stray = [n for n in ("flash_sdpa_folded", "flash_sdpa_folded_v3") if launches[n] != 0]
    if missing or stray:
        fail(f"grad: under grad, not launched {missing}, launched though folded {stray}")


# ------------------------------------------------------------------- docks


def dock(inputs, out, crop, atom_crop):
    """Guided redocking through the port's CLI entry point, with the
    accuracy gate's settings (OVERFIT_GATE.json: 40 steps, 2 rounds of 20
    poses, 64 conformers, pocket cutoff 6 A, fp32)."""
    from physdock_tpu_torch.cli import redocking

    feats = os.path.join(REPO, "demo", "redocking", "features")
    return redocking.main([
        *inputs, "-o", out,
        "--params", PARAMS,
        "--model_name", "toy", "--crop_size", str(crop), "--atom_crop_size", str(atom_crop),
        "--msa_features_dir", os.path.join(feats, "msa_features"),
        "--uniprot_msa_features_dir", os.path.join(feats, "uniprot_msa_features"),
        "--steps", "40", "--max_rounds", "2", "--num_samples_per_round", "20",
        "--max_samples", "40", "--num_confs", "64", "--pocket_cutoff", "6.0",
        "--use_pocket", "--use_key_res", "--enable_physics_correction",
        "--enable_ranking", "--device", "cuda",
    ])


def phase_accuracy(work):
    results = dock(["-f", SYSTEMS], os.path.join(work, "accuracy"), 128, 1024)
    if len(results) != 4:
        fail(f"accuracy dock returned {len(results)} results, expected 4")
    tops = {}
    for r in results:
        if "error" in r or not r.get("top5_rmsd"):
            fail(f"accuracy dock: {r.get('system_id')}: {r.get('error', 'no rmsd')}")
        tops[r["system_id"]] = r["top5_rmsd"][0]
    return tops


def phase_main(work):
    return dock(["-i", os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz")],
                os.path.join(work, "main"), 256, 2048)


# ------------------------------------------------------------------- train

TRAIN_STEPS = 3


def phase_train(torch, work):
    """The train CLI at full width; returns launches per step."""
    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.train import checkpoint as ckpt_lib
    from physdock_tpu_torch.train import train
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.step import init_train_state

    data = os.path.join(work, "train_data", "train_val")
    os.makedirs(data)
    for f in sorted(os.listdir(SYSTEMS)):
        os.symlink(os.path.join(SYSTEMS, f), os.path.join(data, f))
    out = os.path.join(work, "train_ckpt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _flash_lib.reset_launches()
    t0 = time.time()
    res = train.main([
        "--dataset_dir", os.path.dirname(data), "-o", out, "--model_name", "medium",
        "--crop_size", "256", "--atom_crop_size", "2048", "--num_augmentation_sample", "48",
        "--batch_size", "1", "--total_steps", str(TRAIN_STEPS), "--save_every", str(TRAIN_STEPS),
        "--seed", "0", "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_flash_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    state, model = res["state"], res["model"]
    n_params = sum(p.numel() for p in model.parameters())
    losses = [lg["loss"] for lg in res["logs"]]
    log(f"[train] medium ({n_params} parameters) crop 256/2048, 48 samples: steps "
        f"{res['steps']} losses {losses} sampler retries {res['retries']}")
    for lg in res["logs"]:
        log(f"[train]   {json.dumps(lg)}")
    sec, wait = res["step_seconds"], res["wait_seconds"]
    log(f"[train] seconds per step {sec} (steps 2-3 mean {sum(sec[1:]) / len(sec[1:]):.3f}), "
        f"of which waiting for the batch and its copy {wait}; peak memory allocated {peak} B "
        f"({peak / 2**30:.2f} GiB); wall {wall:.2f} s")
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    log(f"[train] launches per step: {json.dumps(per_step)}")
    if res["steps"] != list(range(1, TRAIN_STEPS + 1)) or not all(
            math.isfinite(v) for lg in res["logs"] for v in lg.values()):
        fail(f"train: steps {res['steps']} or non-finite losses {res['logs']}")
    if res["retries"] != 0:
        fail(f"train: {res['retries']} sampler retries")
    for n in ("flash_fwd_lse", "flash_bwd", "flash_sdpa_grouped", "flash_sdpa"):
        if launches[n] <= 0:
            fail(f"train: {n} never launched")

    t0 = time.time()
    init = load_model(None, PhysDockConfig.named("medium", num_augmentation_sample=48), seed=0)
    init_sd = init.state_dict()
    moved_p = sum(float((state.params[n].detach().cpu() - init_sd[n]).abs().sum()) for n in init_sd)
    moved_e = sum(float((state.ema_params[n].cpu() - init_sd[n]).abs().sum()) for n in init_sd)
    log(f"[train] sum |params - init| {moved_p:.6g}, sum |ema - init| {moved_e:.6g}")
    if not (moved_p > 0 and moved_e > 0):
        fail("train: params or EMA did not move")
    path = res["checkpoints"][-1] if res["checkpoints"] else None
    if path != ckpt_lib.latest_checkpoint(out) or not path.endswith(f"step_{TRAIN_STEPS:08d}.pt"):
        fail(f"train: checkpoint {path} is not the newest step-{TRAIN_STEPS} one")
    fresh = init_train_state(init, make_optimizer())
    restored = ckpt_lib.restore_train_state(path, fresh)
    same = restored.step == TRAIN_STEPS and all(
        torch.equal(restored.params[n].detach(), state.params[n].detach().cpu())
        and torch.equal(restored.ema_params[n], state.ema_params[n].cpu())
        and torch.equal(restored.opt_state.mu[n], state.opt_state.mu[n].cpu())
        for n in state.params)
    if not same:
        fail(f"train: the step-{TRAIN_STEPS} checkpoint does not restore the train state")
    npz = os.path.join(work, "ema_params.npz")
    ckpt_lib.save_params_npz(npz, state.ema_params)
    load_jax_params(PhysDock(model.cfg), npz)  # every key used exactly once, or it raises
    log(f"[train] checkpoint {os.path.basename(path)} restores; EMA exported "
        f"({os.path.getsize(npz)} B) and loaded into a fresh model ({time.time() - t0:.2f} s)")
    return per_step


# -------------------------------------------------------------------- main


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

    t0 = time.time()
    rows = phase_kernels(torch)
    log(f"[kernels] 4 wrappers x 2 dtypes match their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    train_rows = phase_train_kernels(torch)
    log(f"[train_kernels] rows 2 and 4 at {len(TRAIN_FWD_SITES)} training sites and rows 5-6 "
        f"at 2 sites, x 2 dtypes, match their plain versions ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_model(torch)
    log(f"[model] card matches the CPU at crop 256/2048 ({time.time() - t0:.2f} s)")
    t0 = time.time()
    phase_grad(torch)
    log(f"[grad] card matches the CPU for one training step ({time.time() - t0:.2f} s)")

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    t0 = time.time()
    _flash_lib.reset_launches()
    tops = phase_accuracy(work)
    acc_launches = dict(_flash_lib.LAUNCHES)
    t_acc = time.time() - t0
    log(f"[accuracy] top-ranked RMSD (A): {json.dumps(tops)}")
    log(f"[accuracy] launches: {json.dumps(acc_launches)} ({t_acc:.2f} s)")
    bad = {k: v for k, v in tops.items() if not (v < 2.0)}
    if bad:
        fail(f"accuracy dock: top-ranked RMSD >= 2 A: {bad}")

    torch.cuda.synchronize()
    _flash_lib.reset_launches()
    t0 = time.time()
    res = phase_main(work)
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
    per_step = phase_train(torch, work)
    log(f"[train] done ({time.time() - t0:.2f} s)")

    kernels = []
    for name, replaces, _ in kernel_cases():
        r, rb = rows[(name, "float32")], rows[(name, "bfloat16")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "physdock_tpu_torch/csrc/flash_fwd.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bf16_max_abs_err": rb["max_abs_err"], "bf16_ms": rb["ms"],
            "train_launches_per_step": per_step[name],
            "train_sites": {
                site: {"max_abs_err": train_rows[(n, site, "float32")]["max_abs_err"],
                       "bf16_max_abs_err": train_rows[(n, site, "bfloat16")]["max_abs_err"],
                       "ms": train_rows[(n, site, "float32")]["ms"],
                       "plain_ms": train_rows[(n, site, "float32")]["plain_ms"],
                       "bound_ms": train_rows[(n, site, "float32")]["bound_ms"],
                       "library_ms": train_rows[(n, site, "float32")]["library_ms"]}
                for n, site, _ in TRAIN_FWD_SITES if n == name},
        })
    for name, replaces, source in TRAIN_KERNELS:
        r = train_rows[(name, "atom_dit", "float32")]
        rb = train_rows[(name, "atom_dit", "bfloat16")]
        rt = train_rows[(name, "triangle", "float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": int(per_step[name] * TRAIN_STEPS),
            "max_abs_err": max(x["max_abs_err"] for x in (r, rt)),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "bf16_max_abs_err": rb["max_abs_err"], "bf16_ms": rb["ms"],
            "triangle_ms": rt["ms"], "triangle_bound_ms": rt["bound_ms"],
            "train_launches_per_step": per_step[name],
        })
    log(json.dumps({"kernels": kernels}))
    log(f"[summary] wall {time.time() - t_all:.2f} s")
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
