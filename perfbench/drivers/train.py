"""Training traffic: the trainer's step (`train/step.py::make_train_step`,
the plain step, eager) fed by the trainer's own data path
(`train/sampler.py`: `WeightedSystemSampler` over the demo systems,
`batch_iterator` with training-mode featurization and crops, `prefetch`
on a background thread), `batch_size` systems a step, as the train CLI
builds them (`train/train.py::main`).

Set-up builds the one train state (model from the benchmark's weights,
Adam, EMA) and drives it through `check_steps` steps by the window's own
call and feed: these are its warm-up and what the comparison checks. The
same state then trains through the window, which closes at the first
step that ends after `--seconds` (and not before the window's checked
step); the rate is the window over its steps, ending in
`torch.cuda.synchronize()`. A window step whose loss is not finite
counts as failed.

Compared with the plain reference (`perfbench/reference/train.py`), which
follows the same steps from the same weights and features:

  * loss: each checked step's loss, relative;
  * grad: the first step's gradient as Adam received it (its first
    moment after one step over 1 - b1), each leaf's norm;
  * change: each leaf's parameter change after the checked steps, its
    norm;
  * win_grad, win_change: the same for one step of the window, drawn
    from the seed among its first `window_check_within`: the reference
    takes that step's batch and the program's parameters and Adam moments
    before it, and the gradient is read from the first moment before and
    after it. That step's loss gap (win_loss) is read but has no limit:
    the control does not separate it from the program's.

The traffic's `limits` name the numbers compared.

A leaf's gap is |program - reference| over the larger of the reference's
norm of that leaf and of the median leaf, the worst leaf counted. Leaves
whose reference gradient is under a thousandth of the median leaf's
(nought to rounding, as a key's bias under softmax) are left out of both.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List

import numpy as np

from perfbench.lib.harness import ROOT, Result

SPAN_TARGETS = (
    ("physdock_tpu_torch.ops.attention", None, "flash_fwd_lse", "flash_fwd_lse"),
    ("physdock_tpu_torch.ops.attention", None, "flash_bwd", "flash_bwd"),
)
SPANS = ("window", "data", "flash_fwd_lse", "flash_bwd")


def build(ctx, spec):
    """(model, train_step, state, batches, program seed) as the train CLI
    builds them, the model from the benchmark's weights."""
    import torch

    from perfbench.lib import weights as wlib
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.train.optim import make_optimizer
    from physdock_tpu_torch.train.sampler import WeightedSystemSampler, batch_iterator, prefetch
    from physdock_tpu_torch.train.step import init_train_state, make_train_step
    from physdock_tpu_torch.utils.compile_cache import enable

    enable()
    p = ctx.params
    seed = ctx.seed % 2 ** 31
    cfg = PhysDockConfig.named(ctx.config["preset"], crop_size=p["crop"],
                               atom_crop_size=p["atom_crop"], bf16=p["dtype"] == "bfloat16",
                               inference_mode=False, num_augmentation_sample=p["augmentation"])
    with torch.device("meta"):
        model = PhysDock(cfg.model, dtype=cfg.dtypes.compute_dtype)
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(wlib.make(spec, ctx.seed, ctx.device), strict=True)
    model.train()
    optimizer = make_optimizer(p["lr"], p["warmup_steps"])
    state = init_train_state(model, optimizer)
    step = make_train_step(model, optimizer, cfg.loss, ema_decay=0.999,
                           sigma_data=cfg.model.sigma_data)
    data = os.path.join(ctx.tmp, "dataset", "train_val")
    if not os.path.isdir(data):
        os.makedirs(data)
        for f in sorted(glob.glob(os.path.join(ROOT, p["systems"], "*.pkl.gz"))):
            if os.path.basename(f).replace(".pkl.gz", "") not in p.get("exclude", ()):
                os.symlink(f, os.path.join(data, os.path.basename(f)))
    featurizer = SystemFeaturizer(cfg.data, inference_mode=False, seed=seed, pad_to_bucket=False)
    sampler = WeightedSystemSampler.from_dataset_dir(os.path.dirname(data), seed)
    batches = prefetch(batch_iterator(sampler, featurizer, p["batch_size"], p["crop"],
                                      p["atom_crop"]))
    return model, step, state, batches, seed


def _snapshot(state, moments=("mu", "nu")):
    """Copies of the train state's parameters and Adam moments, and its
    update count."""
    opt = state.opt_state
    return ({k: v.detach().clone() for k, v in state.params.items()},
            *({k: v.clone() for k, v in getattr(opt, m).items()} for m in moments), opt.count)


def _checked_steps(state, train_step, next_batch, seed, n):
    """The first `n` steps: the batches fed, the losses, the first step's
    gradient as Adam received it (its first moment over 1 - b1) and each
    leaf's change after the `n` steps, as per-leaf norms."""
    from perfbench.reference import train as tref

    theta0 = {k: v.detach().clone() for k, v in state.params.items()}
    fed, losses = [], []
    for i in range(n):
        host, batch = next_batch()
        fed.append(host)
        state, logs = train_step(state, batch, seed)
        losses.append(logs["loss"])
        if i == 0:
            grad = tref.norms({k: v / 0.1 for k, v in state.opt_state.mu.items()})
    return state, fed, losses, grad, tref.moved(state.params, theta0)


def _steps(state, train_step, next_batch, seed, pick, stop, cuda):
    """Steps the state until `stop(steps)` holds once step `pick` (from 0)
    is done: every step's loss, and step `pick`'s batch with the state
    before and after it."""
    import torch

    losses, checked = [], None
    while True:
        host, batch = next_batch()
        before = _snapshot(state) if len(losses) == pick else None
        state, logs = train_step(state, batch, seed)
        losses.append(logs["loss"])
        if before is not None:
            checked = {"host": host, "before": before, "loss": logs["loss"],
                       "after": _snapshot(state, ("mu",))[:2]}
        if cuda:
            torch.cuda.synchronize()
        if len(losses) > pick and stop(len(losses)):
            return state, losses, checked


def _pick(ctx) -> int:
    """The window step that the comparison checks, drawn from the seed."""
    return int(np.random.default_rng([ctx.seed % 2 ** 63, 3]).integers(
        int(ctx.params["window_check_within"])))


def run(ctx) -> Result:
    import torch

    from perfbench.lib import trace as tr
    from perfbench.reference import physdock as ref
    from physdock_tpu_torch.infer.pipeline import arrays_to_device

    p = ctx.params
    cuda = ctx.device == "cuda"
    spec = ref.param_spec(ctx.config)
    model, train_step, state, batches, seed = build(ctx, spec)
    sizes: List[tuple] = []
    spans = tr.Spans(_targets(), keep_args=("flash_fwd_lse", "flash_bwd")) if ctx.trace else None
    data_s = [0.0]

    def next_batch():
        t = time.perf_counter()
        with tr.span("data"):
            host = next(batches)
            batch = arrays_to_device(host, ctx.device)
            if cuda:
                torch.cuda.synchronize()
        data_s[0] += time.perf_counter() - t
        s = host["s_mask"]
        sizes.append((int(s.sum()), int(host["a_mask"].sum()),
                      int((np.abs(host["msa_feat"][..., :32]).sum(-1) > 0).any(-1).sum())))
        return host, batch

    try:
        # the checked steps: set-up and warm-up, through the window's own call
        state, fed, losses, grad, change = _checked_steps(state, train_step, next_batch, seed,
                                                          int(p["check_steps"]))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        sizes.clear()
        data_s[0] = 0.0
        prof = _profiler() if ctx.trace else None
        if prof is not None:
            spans.__enter__()
            prof.__enter__()
        seconds = ctx.window_seconds()
        t0 = ctx.open_window()
        try:
            with tr.span("window"):
                state, win_losses, window = _steps(
                    state, train_step, next_batch, seed, _pick(ctx),
                    lambda n: time.time() - t0 >= seconds, cuda)
            t1 = time.time()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                spans.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        batches.close()
    steps = len(win_losses)
    failed = int((~np.isfinite(win_losses)).sum())  # a checked step's shows in its gap
    del model, state, train_step
    layer = busy = window_s = breakdown = None
    if ctx.trace:
        layer, busy, window_s, breakdown = _reduce(ctx, prof, spans, sizes, steps, data_s[0])
        del prof
    if cuda:
        torch.cuda.empty_cache()
    got = numbers(ctx, spec, fed, seed, (losses, grad, change), window)["program"]
    checks = {k: (got[k], lim) for k, lim in ctx.limits.items()}
    return Result(attempted=steps, failed=failed,
                  e2e={"train_step_s": (t1 - t0) / steps}, checks=checks,
                  memory_peak_bytes=peak, layer=layer, busy_s=busy, window_s=window_s,
                  breakdown=breakdown)


def numbers(ctx, spec, fed, seed, program, window, controls=()) -> Dict[str, Dict]:
    """The loss, gradient and change gaps against the reference at the
    cell's precision, and of the reference at each of `controls` standing
    in the program's place: of the checked steps (`program`: losses,
    per-leaf gradient norms, per-leaf change norms), and, as `win_*`, of
    the window's checked step (`window`: its batch and loss, the state
    before it and the parameters and first moment after it), which the
    reference takes from the state before it."""
    import torch

    from perfbench.lib import weights as wlib
    from perfbench.reference import train as tref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, c = ctx.params, ctx.config
    prec = {"bfloat16": "bf16", "float32": "fp32"}[p["dtype"]]

    def to_dev(h):
        return {k: torch.as_tensor(np.asarray(v)[0], device=ctx.device) for k, v in h.items()}

    def gaps(name, start, W0, batches, mu0, nu0, got_program):
        def run(mode):
            out = tref.train_steps(c, W0, batches, mode, seed, p["augmentation"],
                                   int(p["reference_chunk"]), start, mu0, nu0)
            return out["losses"], tref.norms(out["grad"]), tref.moved(out["params"], W0)

        want = run(prec)
        med = float(np.median(list(want[1].values())))
        keep = [k for k, v in want[1].items() if v >= 1e-3 * med]
        for row, got in [("program", got_program)] + [(m, run(m)) for m in controls]:
            g_gap, g_leaf = tref.leaf_gap(got[1], want[1], keep)
            c_gap, c_leaf = tref.leaf_gap(got[2], want[2], keep)
            out.setdefault(row, {}).update({
                name + "loss": max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0])),
                name + "grad": g_gap, name + "change": c_gap, f"_{name}grad_leaf": g_leaf,
                f"_{name}change_leaf": c_leaf, f"_{name}left_out": len(want[1]) - len(keep),
                f"_{name}losses": list(got[0]), f"_{name}ref_losses": list(want[0])})

    out: Dict[str, Dict] = {}
    gaps("", 0, wlib.make(spec, ctx.seed, ctx.device), [to_dev(h) for h in fed], None, None,
         program)
    Wb, mub, nub, count = window["before"]
    after, mu_after = window["after"]
    win_grad = tref.norms({k: (mu_after[k] - 0.9 * mub[k]) / 0.1 for k in mu_after})
    gaps("win_", count, Wb, [to_dev(window["host"])], mub, nub,
         ([window["loss"]], win_grad, tref.moved(after, Wb)))
    return out


def readings(ctx, seeds, controls=("fp8",)) -> List[Dict]:
    """The numbers compared for the program and for each control, over
    `seeds` in one process: each seed builds its train state, runs the
    checked steps and then the window's steps as far as its checked one
    (no clock). This sets the limits; the benchmark's runs do not call
    it."""
    import json

    import torch

    from perfbench.reference import physdock as ref
    from physdock_tpu_torch.infer.pipeline import arrays_to_device

    spec = ref.param_spec(ctx.config)
    rows = []
    cuda = ctx.device == "cuda"
    for s in seeds:
        ctx.seed = int(s)
        model, train_step, state, batches, seed = build(ctx, spec)

        def next_batch():
            host = next(batches)
            return host, arrays_to_device(host, ctx.device)

        try:
            t0 = time.time()
            state, fed, losses, grad, change = _checked_steps(
                state, train_step, next_batch, seed, int(ctx.params["check_steps"]))
            state, win_losses, window = _steps(state, train_step, next_batch, seed, _pick(ctx),
                                               lambda n: True, cuda)
            steps_s = time.time() - t0
        finally:
            batches.close()
        del model, state, train_step
        if cuda:
            torch.cuda.empty_cache()
        row = {"seed": ctx.seed, "steps_s": steps_s, "window_pick": _pick(ctx),
               **numbers(ctx, spec, fed, seed, (losses, grad, change), window, controls)}
        del window
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def _targets():
    import importlib

    out = []
    for mod, cls, attr, name in SPAN_TARGETS:
        owner = importlib.import_module(mod)
        out.append((getattr(owner, cls) if cls else owner, attr, name))
    return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _reduce(ctx, prof, spans, sizes, steps, data_s):
    import json

    import torch

    from perfbench import flops
    from perfbench.lib import trace as tr

    path = os.path.join(ctx.tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    summ = tr.reduce_trace(events, SPANS)
    del events
    c, p = ctx.config, ctx.params
    fwd = sum(flops.train_forward_flops(c, n, a, m, p["augmentation"]) for n, a, m in sizes)
    kind = torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu"
    layer = {"trace": summ, "spans": spans, "steps": steps, "data_s": data_s,
             "flops": 3 * fwd, "peak_flops": flops.peak_flops(kind, "bf16"),
             "device_kind": kind, "fwd_lse": spans.args.get("flash_fwd_lse", []),
             "bwd": spans.args.get("flash_bwd", [])}
    breakdown = {"device_ops": [[n, s] for n, s in summ.device_ops[:10]],
                 "idle_gaps": [[n, s] for n, s in summ.idle_gaps[:10]]}
    return layer, summ.busy_s, summ.window_s, breakdown
