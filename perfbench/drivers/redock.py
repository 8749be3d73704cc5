"""Redocking traffic: jobs of the demo PoseBusters systems through
`DockingPipeline.dock_many`, the pipeline built as the redocking CLI
builds it (`cli/common.py::build_pipeline`, with the traffic's flags).

A job docks every system of `params["systems"]` once, in an order drawn
from the seed, with `batch_size` systems to a sampler pass. The rate
counts the poses sampled (rounds x poses per round) of every system whose
result keeps the round protocol's promise: as many ranked poses as its
chirality verdicts entitle it to (the accepted ones, or, with fewer
accepted than a round samples, accepted and rejected ones up to
`max_samples`), each with a finite RMSD, and the top five written. A
system that breaks it counts as failed. The window
opens after a warm-up job at `warmup_steps` reverse steps (the same
shapes, so nothing builds or grows inside the window) and closes at the
first job completion after `--seconds`. Outputs go to a temporary
directory that is removed after each job.

What the window produced is checked against the plain reference
(`perfbench/reference/`) after the window, with the program freed:

  * trunk: (s, z) of one system and round of the first job, drawn from
    the seed, against the reference trunk on the same features;
  * denoiser: one reverse step of that job, drawn from the seed: the
    network output r = (x_denoised - c_skip x_hat) / c_out of every pose
    of the pass (20 per system, for every system in the pass), against
    the reference denoiser given the same x_hat and t_hat and its own
    trunk;
  * guidance: the force-field projection at the last reverse step of one
    round of that job, drawn from the seed: each pose's relaxed ligand
    placed onto its denoised ligand, against the reference field, its
    relaxation and its Kabsch fit;
  * chirality: every chirality verdict of that job, against the signed
    volumes of the reference field's chiral centres on the same poses
    (poses whose volume is too small for its sign to be decided by
    rounding are left out); the count that differ.

Each of the first three is the largest error over valid rows (masked tokens and
atoms left out), scaled by the reference's RMS for the trunk and the
denoiser, and by the largest ligand coordinate for the guidance (fp32
rounding of coordinates grows with their size: with random weights the
poses of the second round lie thousands of Angstrom out).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np

from perfbench.lib.harness import ROOT, Result

SPAN_TARGETS = (
    # (module, class or None, attribute, span)
    ("physdock_tpu_torch.infer.pipeline", "DockingPipeline", "dock_many", "job"),
    ("physdock_tpu_torch.infer.pipeline", "DockingPipeline", "_load", "load"),
    ("physdock_tpu_torch.model.physdock", "PhysDock", "conditioning", "trunk"),
    ("physdock_tpu_torch.model.physdock", "PhysDock", "denoise_bias_cache", "bias_cache"),
    ("physdock_tpu_torch.model.physdock", "PhysDock", "denoise", "denoise"),
    ("physdock_tpu_torch.infer.pipeline", None, "sample_diffusion", "sampler"),
    ("physdock_tpu_torch.infer.pipeline", None, "sample_diffusion_batched", "sampler"),
    ("physdock_tpu_torch.infer.pipeline", "DockingPipeline", "_build_guidance", "guidance"),
    ("physdock_tpu_torch.model.diffusion", None, "select_best_conformers", "guidance"),
    ("physdock_tpu_torch.model.diffusion", None, "relax_positions", "guidance"),
    ("physdock_tpu_torch.model.diffusion", None, "weighted_rigid_align", "guidance"),
    ("physdock_tpu_torch.infer.pipeline", None, "chirality_correct", "guidance"),
    ("physdock_tpu_torch.infer.pipeline", "DockingPipeline", "_postprocess", "post"),
    ("physdock_tpu_torch.ops.attention", None, "flash_sdpa_folded_v3", "flash_sdpa_folded_v3"),
)
SPANS = sorted({t[3] for t in SPAN_TARGETS} | {"window", "load_wait"})


def _cli_args(ctx, preset: str):
    from physdock_tpu_torch.cli import common

    p = ctx.params
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser)
    argv = ["-o", ctx.tmp, "--model_name", preset, "--device", ctx.device,
            "--seed", str(ctx.seed % 2 ** 31)] + [str(x) for x in p["flags"]]
    for flag, rel in p.get("path_flags", {}).items():
        argv += [flag, os.path.join(ROOT, rel)]
    return parser.parse_args(argv)


def build_pipeline(ctx, spec):
    """The CLI's pipeline, its model built on the device with the
    benchmark's weights from the seed."""
    import torch

    from perfbench.lib import weights as wlib
    from physdock_tpu_torch.cli import common
    from physdock_tpu_torch.model.physdock import PhysDock

    def load_model(path, cfg, seed=0, with_confidence=False, ckpt=None):
        with torch.device("meta"):
            model = PhysDock(cfg.model, dtype=cfg.dtypes.compute_dtype)
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(wlib.make(spec, ctx.seed, ctx.device), strict=True)
        return model

    orig = common.load_model
    common.load_model = load_model
    try:
        return common.build_pipeline(_cli_args(ctx, ctx.config["preset"]))
    finally:
        common.load_model = orig


class Flags:
    """The program's chirality verdicts of every round, in call order (a
    [poses] or, batched, [systems, poses] tensor each); while `sink` is a
    list, each verdict goes there too with the ligand poses it judged."""

    def __init__(self):
        from physdock_tpu_torch.infer import pipeline

        self.mod, self.orig = pipeline, pipeline.chirality_correct
        self.calls: List = []
        self.sink = None

        def chirality_correct(lig, ff):
            ok = self.orig(lig, ff)
            self.calls.append(ok)
            if self.sink is not None:
                self.sink.append(("chir", lig.detach().clone(), ok))
            return ok

        pipeline.chirality_correct = chirality_correct

    def remove(self):
        self.mod.chirality_correct = self.orig


class Capture:
    """Records, during one job, what the comparison needs: every trunk
    call's features and (s, z), the chosen denoiser call's x_hat, t_hat
    and output, each last-step guidance projection, each system's ligand
    as its guidance was built, and each chirality verdict with its poses."""

    def __init__(self, pipe, flags: Flags, den_pick: int, steps: int):
        from physdock_tpu_torch.model import diffusion

        self.pipe, self.flags, self.den_pick, self.steps = pipe, flags, den_pick, steps
        self.events: List[tuple] = []
        self.n_den = 0
        self.diffusion = diffusion
        model = pipe.model
        cond, den, guid = model.conditioning, model.denoise, pipe._build_guidance
        align = diffusion.weighted_rigid_align

        def conditioning(batch):
            out = cond(batch)
            self.events.append(("cond", {k: v.clone() for k, v in batch.items()},
                                out[2].clone(), out[3].clone()))
            return out

        def denoise(batch, x_hat, t_hat, *rest, **kw):
            out = den(batch, x_hat, t_hat, *rest, **kw)
            if self.n_den == self.den_pick:
                self.events.append(("den", x_hat.clone(), t_hat.clone(), out.clone()))
            self.n_den += 1
            return out

        def build_guidance(batch, meta, pad_atoms=None):
            out = guid(batch, meta, pad_atoms)
            mol = meta["ref_mol"]
            self.events.append(("guid", dict(
                atomic_numbers=list(mol.atomic_numbers), bonds=[(i, j) for i, j, _ in mol.bonds],
                conf0=np.asarray(out[1][0]), chiral=mol.chiral_centers(),
                rigid14=[(min(a, b), max(a, b))
                         for a, _, _, b, _ in getattr(mol, "stereo_bonds", None) or []],
                lig_idx=np.asarray(meta["ligand_atom_idx"]))))
            return out

        def weighted_rigid_align(x_pred, x_gt, weights):
            out = align(x_pred, x_gt, weights)
            if (self.n_den - 1) % self.steps == self.steps - 1:
                self.events.append(("align", x_pred.clone(), out.clone()))
            return out

        model.conditioning, model.denoise = conditioning, denoise
        pipe._build_guidance = build_guidance
        diffusion.weighted_rigid_align = weighted_rigid_align
        self._align = align
        flags.sink = self.events

    def remove(self):
        del self.pipe.model.conditioning
        del self.pipe.model.denoise
        del self.pipe._build_guidance
        self.diffusion.weighted_rigid_align = self._align
        self.flags.sink = None
        self.pipe = None  # the program is freed before the reference runs

    def before(self, pos: int, kind: str, n: int) -> list:
        """The last `n` events of `kind` before position `pos`."""
        got = [e for e in self.events[:pos] if e[0] == kind]
        return got[-n:]


def _picks(seed: int, nsys: int, bsz: int, s):
    """From the seed: the random source of the job orders, the
    denoiser call and the system of a pass that the comparison checks, and
    the warm-up job's order."""
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    passes = nsys if bsz == 1 else -(-nsys // bsz)
    den_pick = int(rng.integers(passes * s.max_rounds * s.steps))
    pick_b = int(rng.integers(bsz))
    return rng, den_pick, pick_b, rng.permutation(nsys)


def _job(pipe, flags: Flags, systems, order, out_root, batch_size):
    """One job: its results, and for each whether it kept the promise."""
    results: List[Dict] = []
    first = len(flags.calls)
    try:
        pipe.dock_many([systems[i] for i in order], out_root, batch_size=batch_size,
                       results=results)
        kept = [_kept(r, acc, pipe.s, out_root)
                for r, acc in zip(results, _accepted(results, flags.calls[first:]))]
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    return results, kept


def _checked_job(pipe, flags, systems, order, out_root, batch_size, den_pick):
    """`_job` while a `Capture` records what the comparison needs."""
    cap = Capture(pipe, flags, den_pick, pipe.s.steps)
    try:
        res, kept = _job(pipe, flags, systems, order, out_root, batch_size)
    finally:
        cap.remove()
    return res, kept, cap


def _accepted(results, calls) -> List:
    """Each result's count of poses that passed the chirality check, from
    the verdicts of its rounds (results and rounds come in the same order;
    a batched verdict covers every system of its pass)."""
    out: List = []
    i = 0
    while len(out) < len(results):
        block = [c.cpu().numpy() for c in calls[i:i + results[len(out)]["rounds"]]]
        if not block:
            return out + [None] * (len(results) - len(out))
        i += len(block)
        for b in range(block[0].shape[0] if block[0].ndim == 2 else 1):
            out.append(int(sum((c[b] if c.ndim == 2 else c).sum() for c in block)))
    return out


def _kept(r: Dict, accepted, s, out_root: str) -> bool:
    """Whether a result holds the poses the round protocol promises
    (`infer/rounds.py::RoundProtocol.final_poses`, as the reference's
    redocking loop): the accepted ones, or, with fewer accepted than a
    round samples, accepted and rejected ones, at most `max_samples`; all
    ranked, each with a finite RMSD, the top five written."""
    if accepted is None:
        return False
    per_round = s.num_samples_per_round
    promised = min(accepted if accepted >= per_round else r["rounds"] * per_round,
                   s.max_samples)
    n = r.get("num_poses")
    rm = r.get("all_rmsd") or []
    if (n != promised or sorted(int(i) for i in r["rank_order"]) != list(range(n))
            or len(rm) != n or not all(np.isfinite(rm))):
        return False
    d = os.path.join(out_root, str(r["system_id"]))
    return all(os.path.isfile(f) and os.path.getsize(f) > 0
               for k in range(min(5, n))
               for f in (os.path.join(d, f"pred_rank{k}.pdb"),
                         os.path.join(d, f"ligand_rank{k}.sdf")))


def _timed_items(spans, name: str):
    """Wraps a generator function so that each wait for its next item is a
    span `name` of the benchmark's own, on the host clock too."""
    from torch.profiler import record_function

    def wrap(orig):
        def gen(*args, **kw):
            items = orig(*args, **kw)
            while True:
                t0 = time.perf_counter()
                with record_function(name):
                    item = next(items, None)
                spans.host_s[name] = spans.host_s.get(name, 0.0) + time.perf_counter() - t0
                if item is None:
                    return
                spans.calls[name] = spans.calls.get(name, 0) + 1
                yield item
        return gen
    return wrap


def run(ctx) -> Result:
    import torch

    from perfbench.lib import trace as tr
    from perfbench.reference import physdock as ref
    from physdock_tpu_torch.infer.pipeline import DockingPipeline

    p = ctx.params
    systems = sorted(glob.glob(os.path.join(ROOT, p["systems"], "*.pkl.gz")))
    spec = ref.param_spec(ctx.config)
    pipe = build_pipeline(ctx, spec)
    flags = Flags()
    nsys, bsz = len(systems), int(p["batch_size"])
    settings = pipe.s
    orders, den_pick, pick_b, warm_order = _picks(ctx.seed, nsys, bsz, settings)
    sizes: Dict[str, tuple] = {}
    results: List[Dict] = []
    kept: List[bool] = []
    jobs = 0
    loads = DockingPipeline._loaded_in_order
    try:
        pipe.s = dataclasses.replace(settings, steps=int(p["warmup_steps"]))
        _record_sizes(pipe, sizes, lambda: _job(pipe, flags, systems, warm_order,
                                                os.path.join(ctx.tmp, "warmup"), bsz))
        pipe.s = settings
        if ctx.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        spans = tr.Spans(_targets(), keep_args=("flash_sdpa_folded_v3",)) if ctx.trace else None
        prof = _profiler() if ctx.trace else None
        if prof is not None:
            DockingPipeline._loaded_in_order = _timed_items(spans, "load_wait")(loads)
            spans.__enter__()
            prof.__enter__()
        seconds = ctx.window_seconds()
        t0 = ctx.open_window()
        try:
            with tr.span("window"):
                while True:
                    out_root = os.path.join(ctx.tmp, f"job{jobs}")
                    if jobs == 0:
                        res, ok, capture = _checked_job(pipe, flags, systems,
                                                        orders.permutation(nsys), out_root, bsz,
                                                        den_pick)
                    else:
                        res, ok = _job(pipe, flags, systems, orders.permutation(nsys), out_root,
                                       bsz)
                    results += res
                    kept += ok
                    jobs += 1
                    print(f"job {jobs}: {len(res)} systems, {sum(ok)} kept their poses, by "
                          f"{time.time() - t0:.3f} s", file=sys.stderr, flush=True)
                    if time.time() - t0 >= seconds:
                        break
            if ctx.device == "cuda":
                torch.cuda.synchronize()
            t1 = time.time()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                spans.__exit__(None, None, None)
                DockingPipeline._loaded_in_order = loads
        peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    finally:
        flags.remove()
        pipe.close()
    # every round samples the same number of poses, all of them ranked; how
    # many a result keeps depends on the chirality checks of random weights
    poses = sum(r["rounds"] * settings.num_samples_per_round
                for r, ok in zip(results, kept) if ok)
    failed = nsys * jobs - sum(kept)
    del pipe, flags
    layer = busy = window = breakdown = None
    if ctx.trace:
        layer, busy, window, breakdown = _reduce(ctx, prof, spans, results, sizes, jobs, settings)
        del prof
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    checks = compare(ctx, spec, capture, pick_b)
    return Result(attempted=nsys * jobs, failed=failed,
                  e2e={"redock_poses_per_s": poses / (t1 - t0)},
                  checks=checks, memory_peak_bytes=peak, layer=layer, busy_s=busy,
                  window_s=window, breakdown=breakdown)


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


def _record_sizes(pipe, sizes, fn):
    """Run `fn` while recording each system's real token, atom and MSA-row
    counts (by its reference ligand's position) from the trunk's inputs."""
    cond = pipe.model.conditioning

    def conditioning(batch):
        key = tuple(np.round(batch["x_gt"][:4].float().cpu().numpy().ravel(), 3))
        sizes[key] = (int(batch["s_mask"].sum()), int(batch["a_mask"].sum()),
                      int((batch["msa_tok_c"] >= 0).any(-1).sum()))
        return cond(batch)

    pipe.model.conditioning = conditioning
    try:
        fn()
    finally:
        del pipe.model.conditioning


def _reduce(ctx, prof, spans, results, sizes, jobs, s):
    """The traced window's summary for the metric readers."""
    import torch

    from perfbench import flops
    from perfbench.lib import trace as tr

    path = os.path.join(ctx.tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    summ = tr.reduce_trace(events, SPANS, exclude={"sampler": "guidance"})
    del events
    c = ctx.config
    job_flops = sum(flops.redock_system_flops(c, n_tok, n_atom, n_msa, s.num_samples_per_round,
                                              s.steps) * s.max_rounds
                    for n_tok, n_atom, n_msa in sizes.values())
    kind = torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu"
    layer = {"trace": summ, "spans": spans, "results": results,
             "systems": len(results), "steps": spans.calls.get("denoise", 0),
             "flops": job_flops * jobs, "peak_flops": flops.peak_flops(kind, "bf16"),
             "device_kind": kind, "row1": spans.args.get("flash_sdpa_folded_v3", [])}
    breakdown = {"device_ops": [[n, s] for n, s in summ.device_ops[:10]],
                 "idle_gaps": [[n, s] for n, s in summ.idle_gaps[:10]]}
    return layer, summ.busy_s, summ.window_s, breakdown


def _err(x, ref, mask=None) -> float:
    """Largest |x - ref| over the valid entries, over the reference's RMS."""
    x, ref = x.double(), ref.double()
    if mask is not None:
        x, ref = x[mask], ref[mask]
    return float((x - ref).abs().max() / ref.pow(2).mean().sqrt())


def compare(ctx, spec, cap, pick_b) -> Dict[str, tuple]:
    """The numbers compared, each beside its limit."""
    got = numbers(ctx, spec, cap, pick_b)
    return {k: (got[k], lim) for k, lim in ctx.limits.items()}


def numbers(ctx, spec, cap, pick_b, precision: str = "program") -> Dict[str, float]:
    """The trunk, denoiser and guidance errors of the captured job against
    the fp32 reference, and its chirality verdicts that differ from the
    reference's. With `precision` "tf32" or "bf16" the reference at that
    precision stands in the program's place (the control) for the first
    three; the verdicts are the program's in every row."""
    import torch

    from perfbench.lib import weights as wlib
    from perfbench.reference import guidance as gref
    from perfbench.reference import physdock as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = ctx.config
    W = wlib.make(spec, ctx.seed, ctx.device)
    judge = ref.Ref(W, ref.Prec("fp32"))
    alt = None if precision == "program" else ref.Ref(W, ref.Prec(precision))
    nan = float("nan")
    out = {"trunk": nan, "denoiser": nan, "guidance": nan, "chirality": _chirality(cap)}
    pos = next((i for i, e in enumerate(cap.events) if e[0] == "den"), None)
    if pos is None:
        return out
    with torch.no_grad():
        _, x_hat, t_hat, x_den = cap.events[pos]
        n_sys, n_pose = x_hat.shape[:2]
        conds = cap.before(pos, "cond", n_sys)
        trunk_err, den_err = 0.0, 0.0
        for b, (_, batch, s_prog, z_prog) in enumerate(conds):
            feats = ref.expand_features(batch)
            s_mask, a_mask = feats["s_mask"] > 0, feats["a_mask"] > 0
            want = ref.conditioning(judge, c, batch)
            got = want if alt is None else ref.conditioning(alt, c, batch)
            if alt is not None:
                s_prog, z_prog = got[2], got[3]
            if b == pick_b % n_sys:
                trunk_err = max(_err(s_prog, want[2], s_mask),
                                _err(z_prog, want[3], s_mask[:, None] & s_mask[None, :]))
            c_skip, c_out = ref.edm_parts(t_hat[b], c["sigma_data"])
            r_prog = ((x_den[b].double() - c_skip[:, None, None] * x_hat[b].double())
                      / c_out[:, None, None])
            r_want = ref.denoise(judge, c, batch, x_hat[b], t_hat[b], *want)
            if alt is not None:
                r_prog = ref.denoise(alt, c, batch, x_hat[b], t_hat[b], *got)
            den_err = max(den_err, _err(r_prog, r_want,
                                        a_mask[None, :, None].expand(n_pose, -1, 3)))
            del want, got, r_want
        out["trunk"], out["denoiser"] = trunk_err, den_err

        aligns = [i for i, e in enumerate(cap.events) if e[0] == "align"]
        if aligns:
            pick = np.random.default_rng([ctx.seed % 2 ** 63, 2]).integers(len(aligns))
            apos = aligns[int(pick)]
            _, x_pred, placed = cap.events[apos]
            g_err = 0.0
            for b, (_, g) in enumerate(cap.before(apos, "guid", x_pred.shape[0])):
                field = gref.build_field(g["atomic_numbers"], g["bonds"], g["conf0"],
                                         g["chiral"], g["rigid14"])
                idx = torch.as_tensor(g["lig_idx"], device=x_pred.device)
                lig = x_pred[b][:, idx].float()
                relaxed = gref.relax(lig, field)
                want = gref.kabsch_place(judge.P, relaxed, lig)
                got = (placed[b][:, idx].float() if alt is None
                       else gref.kabsch_place(alt.P, relaxed, lig))
                g_err = max(g_err, float((got.double() - want.double()).abs().max()
                                         / want.double().abs().max()))
            out["guidance"] = g_err
    return out


def _chirality(cap, undecided: float = 1e-5) -> float:
    """How many of the captured job's chirality verdicts differ from the
    reference's: a pose passes where every chiral centre of the reference
    field (signs from the embedded reference conformer) keeps its sign.
    A pose with a centre whose volume lies within `undecided` of zero,
    relative to its three edges' lengths, is left out: rounding decides
    its sign on either side."""
    import torch

    from perfbench.reference import guidance as gref

    wrong = 0
    chirs = [i for i, e in enumerate(cap.events) if e[0] == "chir"]
    if not chirs:
        return float("nan")
    for pos in chirs:
        _, lig, ok = cap.events[pos]
        lig, ok = lig.double(), ok.cpu()
        if lig.dim() == 3:
            lig, ok = lig[None], ok[None]
        for b, (_, g) in enumerate(cap.before(pos, "guid", lig.shape[0])):
            idx, sign = gref.build_field(g["atomic_numbers"], g["bonds"], g["conf0"],
                                         g["chiral"], g["rigid14"])["chiral"]
            if not len(idx):
                want, decided = torch.ones_like(ok[b]), torch.ones_like(ok[b])
            else:
                a, p1, p2, p3 = (lig[b][:, torch.as_tensor(idx[:, j], device=lig.device)]
                                 for j in range(4))
                u, v, w = p1 - a, p2 - a, p3 - a
                vol = (torch.linalg.cross(u, v, dim=-1) * w).sum(-1)
                scale = u.norm(dim=-1) * v.norm(dim=-1) * w.norm(dim=-1)
                s = torch.as_tensor(sign, dtype=vol.dtype, device=vol.device)
                want = (vol * s > 0).all(-1).cpu()
                decided = (vol.abs() > undecided * scale).all(-1).cpu()
            wrong += int(((want != ok[b]) & decided).sum())
    return float(wrong)


def readings(ctx, seeds, controls=("tf32",)) -> List[Dict]:
    """The numbers compared, for the program and for each control
    precision standing in its place, over `seeds` in one process: one
    pipeline, the weights and the sampler's seed set anew per seed, and
    the first job of that seed's window (its order and picks as `run`
    draws them) at the cell's own settings. This sets the limits; the
    benchmark's runs do not call it."""
    import torch

    from perfbench.lib import weights as wlib
    from perfbench.reference import physdock as ref

    p = ctx.params
    systems = sorted(glob.glob(os.path.join(ROOT, p["systems"], "*.pkl.gz")))
    spec = ref.param_spec(ctx.config)
    pipe = build_pipeline(ctx, spec)
    flags = Flags()
    nsys, bsz = len(systems), int(p["batch_size"])
    settings = pipe.s
    rows = []
    try:
        pipe.s = dataclasses.replace(settings, steps=int(p["warmup_steps"]))
        _job(pipe, flags, systems, np.arange(nsys), os.path.join(ctx.tmp, "warmup"), bsz)
        for seed in seeds:
            ctx.seed = int(seed)
            orders, den_pick, pick_b, _ = _picks(ctx.seed, nsys, bsz, settings)
            pipe.model.load_state_dict(wlib.make(spec, ctx.seed, ctx.device), strict=True)
            pipe.s = dataclasses.replace(settings, seed=ctx.seed % 2 ** 31)
            t0 = time.time()
            res, kept, cap = _checked_job(pipe, flags, systems, orders.permutation(nsys),
                                          os.path.join(ctx.tmp, "job"), bsz, den_pick)
            row = {"seed": ctx.seed, "job_s": time.time() - t0, "kept": sum(kept),
                   "poses": [r["num_poses"] for r in res]}
            pipe.model.to_empty(device="meta")  # freed while the reference runs
            if ctx.device == "cuda":
                torch.cuda.empty_cache()
            for prec in ("program",) + tuple(controls):
                row[prec] = numbers(ctx, spec, cap, pick_b, prec)
            pipe.model.to_empty(device=ctx.device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        flags.remove()
        pipe.close()
    return rows
