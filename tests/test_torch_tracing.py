"""The port's spans (`physdock_tpu_torch/utils/profiling.py::span`) and the
benchmark's reading of them (`perfbench/lib/program_spans.py`), on the
CPU, without JAX:

  * with no profiler running a span makes no `record_function` call;
    under one it is a user annotation, as a context manager and as a
    decorator, children wholly inside their parents;
  * under one profiler session, a tiny dock through `dock_many` with the
    featurizer worker (two systems, two rounds of two steps), a dock of one
    system, a tiny train step and one batch of the trainer's loader give
    every span of the redocking and training paths, each child inside its
    parent, and no name of the benchmark's own spans;
  * the model's forward and a reverse pass are the same bit for bit with
    the spans recording and without;
  * the redocking and training CLIs' `--trace_dir` write a trace that
    holds the sampler's steps or the train step;
  * on synthetic traces: the synchronisations counted inside a span (on
    any thread, none just outside it), each per-layer reading by hand, and
    the benchmark's 14 per-layer metrics the same with and without the
    program's spans in the trace.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.lib import harness, program_spans
from perfbench.lib import trace as tr
from physdock_tpu_torch.cli import redocking
from physdock_tpu_torch.cli.common import load_model
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.feat_worker import FeaturizerWorker
from physdock_tpu_torch.data.synthetic import make_synthetic_batch
from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings
from physdock_tpu_torch.model.diffusion import sample_diffusion
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.train import optim
from physdock_tpu_torch.train import train as train_cli
from physdock_tpu_torch.train.sampler import WeightedSystemSampler, batch_iterator
from physdock_tpu_torch.train.step import init_train_state, make_train_step
from physdock_tpu_torch.utils import profiling
from physdock_tpu_torch.utils.profiling import span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "redocking")
SYSTEMS = os.path.join(DEMO, "Posebusters_subset")
PKL = os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz")
PKL2 = os.path.join(SYSTEMS, "5SD5_HWI_A_1.pkl.gz")
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
FZ = dict(msa_features_dir=f"{DEMO}/features/msa_features",
          uniprot_msa_features_dir=f"{DEMO}/features/uniprot_msa_features",
          inference_mode=True, seed=0)
TOY = PhysDockConfig.named("toy", num_augmentation_sample=2)
H100 = "NVIDIA H100 80GB HBM3"

# each span's parents: it lies wholly inside a span of one of them
PARENTS = {
    "physdock.load.features": ("physdock.load",),
    "physdock.load.compact": ("physdock.load",),
    "physdock.load.conformers": ("physdock.load",),
    "physdock.upload": ("physdock.dock",),
    "physdock.guidance.build": ("physdock.dock",),
    "physdock.trunk": ("physdock.dock", "physdock.train.forward"),
    "physdock.trunk.atoms": ("physdock.trunk",),
    "physdock.trunk.msa": ("physdock.trunk",),
    "physdock.trunk.templates": ("physdock.trunk",),
    "physdock.trunk.pairformer": ("physdock.trunk",),
    "physdock.bias_cache": ("physdock.sampler", "physdock.denoise"),
    "physdock.sampler": ("physdock.dock",),
    "physdock.sampler.step": ("physdock.sampler",),
    "physdock.denoise": ("physdock.sampler.step", "physdock.train.forward"),
    "physdock.denoise.atom_encoder": ("physdock.denoise",),
    "physdock.denoise.token_dit": ("physdock.denoise",),
    "physdock.denoise.atom_decoder": ("physdock.denoise",),
    "physdock.step.conformers": ("physdock.sampler.step",),
    "physdock.step.relax": ("physdock.sampler.step",),
    "physdock.step.align": ("physdock.sampler.step",),
    "physdock.round_end": ("physdock.dock",),
    "physdock.post.rank": ("physdock.post",),
    "physdock.post.write": ("physdock.post",),
    "physdock.train.draw": ("physdock.train.step",),
    "physdock.train.forward": ("physdock.train.step",),
    "physdock.train.forward.loss": ("physdock.train.forward",),
    "physdock.train.backward": ("physdock.train.step",),
    "physdock.train.clip": ("physdock.train.step",),
    "physdock.train.update": ("physdock.train.step",),
    "physdock.train.update.adam": ("physdock.train.update",),
    "physdock.train.update.ema": ("physdock.train.update",),
    "physdock.train.update.logs": ("physdock.train.update",),
}
TOP = ("physdock.load", "physdock.load_wait", "physdock.dock", "physdock.post",
       "physdock.post_wait", "physdock.train.step", "physdock.train.batch")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _driver(name):
    return harness.load_module(os.path.join(REPO, "perfbench", "drivers", name + ".py"),
                               "test_tracing_driver_" + name)


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _notes(events):
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _toy_model():
    model = PhysDock(TOY.model)
    load_jax_params(model, NPZ)
    return model


def _train_batch():
    one = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=3)
    return {k: torch.from_numpy(np.asarray(v))[None] for k, v in one.items()}


class _Synthetic:
    """A featurizer for the trainer's loader: a synthetic system."""

    def load(self, path):
        return make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6,
                                    seed=3), {}


def test_a_span_without_a_profiler_calls_no_record_function(monkeypatch):
    calls = []
    enter = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: calls.append(a) or enter(*a))

    @span("physdock.test.fn")
    def fn(x):
        return x + 1

    with span("physdock.test.block"):
        assert fn(1) == 2
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("physdock.test.block"):
            fn(1)
    assert [a[0] for a in calls] == ["physdock.test.block", "physdock.test.fn"]
    assert {"physdock.test.block", "physdock.test.fn"} <= {e.name for e in prof.events()}


def test_spans_nest_as_blocks_and_decorators_and_close_on_errors(tmp_path):
    @span("physdock.test.fn")
    def fn(x):
        """doc"""
        with span("physdock.test.inner"):
            if x < 0:
                raise ValueError("negative")
            return x * 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("physdock.test.outer"):
            assert fn(3) == 6
            with pytest.raises(ValueError, match="negative"):
                fn(-1)
    assert fn.__name__ == "fn" and fn.__doc__ == "doc"
    notes = _notes(_events(prof, tmp_path))
    by = {n: [e for e in notes if e["name"] == n] for n in
          ("physdock.test.outer", "physdock.test.fn", "physdock.test.inner")}
    assert [len(v) for v in by.values()] == [1, 2, 2]
    (outer,) = by["physdock.test.outer"]
    for child, parent in (("physdock.test.fn", [outer]),
                          ("physdock.test.inner", by["physdock.test.fn"])):
        for e in by[child]:
            assert any(_inside(e, p) for p in parent), child


def _inside(e, p) -> bool:
    return (e["tid"] == p["tid"] and p["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-6)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One profiler session: dock_many of two systems through the worker
    (two rounds of two steps), one system docked by itself, one train
    step and one batch of the trainer's loader."""
    out = tmp_path_factory.mktemp("traced")
    torch.set_num_threads(2)
    cfg = PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256,
                               infer_use_pocket=True, infer_use_key_res=True)
    settings = SamplerSettings(max_samples=4, num_samples_per_round=2, max_rounds=2, steps=2,
                               enable_physics_correction=True, num_confs=4,
                               enable_ranking=True, seed=0)
    pipe = DockingPipeline(cfg, load_model(NPZ, cfg), FeaturizerWorker(cfg.data, **FZ),
                           settings, device="cpu")
    model = _toy_model()
    opt = optim.make_optimizer(1e-3, 100)
    step = make_train_step(model, opt, TOY.loss, sigma_data=TOY.model.sigma_data)
    state = init_train_state(model, opt)
    loader = batch_iterator(WeightedSystemSampler(["synthetic"]), _Synthetic(), 1, 16, 48)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            many = pipe.dock_many([PKL, PKL2], str(out / "many"))
            one = pipe.dock(PKL, str(out / "one"))
            state, logs = step(state, _train_batch(), 7)
            next(loader)
    finally:
        pipe.close()
    assert len(many) == 2 and one["rounds"] == 2 and np.isfinite(logs["loss"])
    return _events(prof, out)


def test_a_dock_and_a_train_step_give_every_span_each_inside_its_parent(traced):
    notes = [e for e in _notes(traced) if e["name"].startswith("physdock.")]
    names = {e["name"] for e in notes}
    assert names == set(PARENTS) | set(TOP)
    for e in notes:
        if e["name"] in PARENTS:
            parents = [p for p in notes if p["name"] in PARENTS[e["name"]]]
            assert any(_inside(e, p) for p in parents), e["name"]
    bench = set(_driver("redock").SPANS) | set(_driver("train").SPANS)
    assert not names & bench


def test_the_spans_change_no_number_of_the_model():
    model = _toy_model()
    b = _train_batch()
    one = {k: v[0] for k, v in b.items()}
    x_hat, t_hat = model.augmentation_diffuse(one, torch.Generator().manual_seed(5))

    def run():
        with torch.no_grad():
            out = model.forward_noised(one, x_hat, t_hat)
        poses = sample_diffusion(model, one, generator=torch.Generator().manual_seed(9),
                                 num_sample=2, steps=2)
        return out["x_denoised"], out["p_distogram"], poses

    plain = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spanned = run()
    assert "physdock.sampler.step" in {e.name for e in prof.events()}
    for a, b in zip(plain, spanned):
        assert torch.equal(a, b)


def _trace_names(path):
    with open(os.path.join(path, profiling.TRACE_FILE)) as f:
        return {e["name"] for e in _notes(json.load(f)["traceEvents"])}


def test_the_redocking_cli_writes_a_trace_of_the_spans(tmp_path):
    systems = tmp_path / "systems"
    systems.mkdir()
    for p in (PKL, PKL2):
        os.symlink(p, systems / os.path.basename(p))
    res = redocking.main([
        "-f", str(systems), "-o", str(tmp_path / "out"), "--params", NPZ,
        "--model_name", "toy", "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", FZ["msa_features_dir"],
        "--uniprot_msa_features_dir", FZ["uniprot_msa_features_dir"], "--steps", "2",
        "--max_rounds", "1", "--num_samples_per_round", "2", "--max_samples", "2",
        "--num_confs", "4", "--use_pocket", "--use_key_res", "--enable_physics_correction",
        "--enable_ranking", "--dock_batch_size", "2", "--device", "cpu",
        "--trace_dir", str(tmp_path / "trace")])
    assert len(res) == 2 and all(r["top5_rmsd"] for r in res)
    names = _trace_names(tmp_path / "trace")
    assert {"physdock.sampler.step", "physdock.dock", "physdock.post.rank"} <= names


def test_the_train_cli_writes_a_trace_of_the_spans(tmp_path):
    data = tmp_path / "data" / "train_val"
    data.mkdir(parents=True)
    os.symlink(PKL, data / os.path.basename(PKL))
    summary = train_cli.main([
        "--dataset_dir", str(tmp_path / "data"), "-o", str(tmp_path / "ck"),
        "--model_name", "toy", "--crop_size", "32", "--atom_crop_size", "256",
        "--num_augmentation_sample", "2", "--total_steps", "1", "--save_every", "2",
        "--device", "cpu", "--trace_dir", str(tmp_path / "trace")])
    assert summary["steps"] == [1]
    names = _trace_names(tmp_path / "trace")
    # the loader's batches come from its prefetch thread
    assert {"physdock.train.step", "physdock.train.backward", "physdock.train.batch"} <= names


# ------------------------------------------------------- synthetic traces


def _x(cat, name, ts, end, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "pid": 1,
            "tid": tid, "args": args}


def _kernel(ts, end, corr, launch, tid=1):
    return [_x("kernel", f"kernel_{corr}", ts, end, tid=7, correlation=corr),
            _x("cuda_runtime", "cudaLaunchKernel", launch, launch + 1, tid, correlation=corr)]


def _sync(ts, tid=1, name="cudaStreamSynchronize"):
    return _x("cuda_runtime", name, ts, ts + 2, tid)


def _notes_of(spans, tid=1):
    return [_x("user_annotation", n, s, e, tid) for n, s, e in spans]


def _train_trace():
    """A window of one train step (µs): kernels [30,100], [150,250],
    [320,500] (launched by the backward on thread 2), [650,690],
    [720,900]; idle [0,30] (step), [100,150] and [250,320] (forward),
    [500,650] (backward), [690,720] and [900,1000] (update)."""
    base = _notes_of([("window", 0, 1000), ("data", 0, 10), ("flash_fwd_lse", 40, 60)])
    base += _notes_of([("flash_bwd", 420, 440)], tid=2)
    for k in (_kernel(30, 100, 1, 25), _kernel(150, 250, 2, 45), _kernel(320, 500, 3, 425, 2),
              _kernel(650, 690, 4, 610), _kernel(720, 900, 5, 715)):
        base += k
    base += [_sync(5, name="cudaEventSynchronize"), _sync(995), _sync(616, name="cudaMemcpyAsync")]
    program = _notes_of([
        ("physdock.train.step", 10, 990), ("physdock.train.draw", 12, 18),
        ("physdock.train.forward", 20, 300), ("physdock.train.forward.loss", 250, 300),
        ("physdock.train.backward", 300, 600), ("physdock.train.clip", 600, 700),
        ("physdock.train.update", 700, 980), ("physdock.train.update.adam", 710, 720),
        ("physdock.train.update.ema", 720, 890), ("physdock.train.update.logs", 900, 980)])
    # the loader's thread: left out of the reduction
    program += _notes_of([("physdock.train.batch", 100, 900)], tid=3)
    program += [_sync(950), _sync(450, tid=2), _sync(615, name="cudaMemcpy")]
    return base, program


def _redock_trace():
    """A window of two reverse steps (µs): kernels [120,280] (trunk),
    [340,580] (row 1), [640,660] (align), [720,980], [1050,1250],
    [1450,1690]; idle inside the steps [580,640], [660,720] and
    [1250,1450], outside them [0,120], [280,340], [980,1050] and
    [1690,2000]."""
    base = _notes_of([
        ("window", 0, 2000), ("job", 0, 2000), ("load_wait", 0, 100), ("load", 0, 100),
        ("trunk", 100, 300), ("sampler", 300, 1800), ("bias_cache", 300, 320),
        ("denoise", 320, 600), ("flash_sdpa_folded_v3", 330, 345), ("guidance", 600, 700),
        ("denoise", 1020, 1300), ("guidance", 1300, 1400), ("post", 1800, 2000)])
    for k in (_kernel(120, 280, 1, 110), _kernel(340, 580, 2, 335), _kernel(640, 660, 3, 620),
              _kernel(720, 980, 4, 710), _kernel(1050, 1250, 5, 1030),
              _kernel(1450, 1690, 6, 1420)):
        base += k
    base += [_sync(1010), _sync(1900)]
    program = _notes_of([
        ("physdock.load_wait", 0, 100), ("physdock.load", 0, 100), ("physdock.dock", 100, 1800),
        ("physdock.trunk", 100, 300), ("physdock.sampler", 300, 1800),
        ("physdock.bias_cache", 300, 320), ("physdock.sampler.step", 320, 1000),
        ("physdock.denoise", 320, 600), ("physdock.step.align", 600, 700),
        ("physdock.sampler.step", 1020, 1700), ("physdock.denoise", 1020, 1300),
        ("physdock.step.align", 1300, 1400), ("physdock.post", 1800, 2000)])
    program += [_sync(650), _sync(1350)]
    return base, program


def _layer(kind, events):
    """`Result.layer` as the cell's driver builds it from this trace."""
    driver = _driver(kind)
    spans = tr.Spans(())
    if kind == "redock":
        spans.host_s = {"load_wait": 0.4, "load": 0.3}
        spans.calls = {"denoise": 2}
        att = ((20, 2048, 128), "float32", 4)
        return {"trace": tr.reduce_trace(events, driver.SPANS, exclude={"sampler": "guidance"}),
                "spans": spans, "results": [], "systems": 4, "steps": 2, "flops": 3e12,
                "peak_flops": 989.4e12, "device_kind": H100,
                "row1": [(att, att, att, ((4, 2048, 2048), "float32", 4), 4)]}
    bf = ((48, 4, 2048, 32), "bfloat16", 2)
    call = (bf, bf, bf, ((4, 2048, 2048), "bfloat16", 2))
    return {"trace": tr.reduce_trace(events, driver.SPANS), "spans": spans, "steps": 2,
            "data_s": 0.01, "flops": 2e12, "peak_flops": 989.4e12, "device_kind": H100,
            "fwd_lse": [call], "bwd": [call]}


def test_syncs_count_on_any_thread_inside_the_span_and_none_outside():
    base, program = _train_trace()
    syncs = program_spans.count_syncs(base + program, ["physdock.train.step",
                                                       "physdock.train.backward",
                                                       "physdock.train.update.logs",
                                                       "physdock.train.draw"])
    # 950 (logs), 450 on the autograd thread (backward), the synchronous
    # copy at 615; not the asynchronous copy, nor 5 and 995 (outside)
    assert syncs == {"physdock.train.step": 3, "physdock.train.backward": 1,
                     "physdock.train.update.logs": 1, "physdock.train.draw": 0}


@pytest.mark.parametrize("name, kind, want", [
    ("autograd.forward_idle_ms.train", "train", (50 + 70) / 1e3 / 2),
    ("autograd.backward_idle_ms.train", "train", 150 / 1e3 / 2),
    ("autograd.update_idle_ms.train", "train", (30 + 100) / 1e3 / 2),
    ("autograd.syncs_per_step.train", "train", 3 / 2),
    ("sampler.step_idle_ms.redock", "redock", (60 + 60 + 200) / 1e3 / 2),
    ("sampler.syncs_per_step.redock", "redock", 2 / 2),
])
def test_each_program_reading_by_hand(name, kind, want):
    base, program = _train_trace() if kind == "train" else _redock_trace()
    events = base + program
    run = dict(_layer(kind, events),
               program=program_spans.summarize(events, _driver(kind).SPANS))
    assert program_spans.READINGS[name](run) == pytest.approx(want, rel=1e-12)
    # every idle gap is put down to a phase of the program
    assert program_spans.unnamed_share(run["program"]) == 0.0
    # a program without spans gives no reading; in the train step no
    # span of the benchmark's is open inside the window but the window
    bare = dict(_layer(kind, base), program=program_spans.summarize(base, _driver(kind).SPANS))
    assert program_spans.READINGS[name](bare) is None
    if kind == "train":
        assert program_spans.unnamed_share(bare["program"]) == 1.0


EXISTING = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "perfbench", "metrics"))
                  if f.endswith(".py"))


def test_the_benchmark_has_fourteen_per_layer_metrics():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert EXISTING == sorted(m["name"] for m in bench["per_layer"]) and len(EXISTING) == 14


@pytest.mark.parametrize("name", EXISTING)
def test_existing_metrics_read_the_same_with_the_program_spans(name):
    reader = harness.load_module(os.path.join(REPO, "perfbench", "metrics", name + ".py"),
                                 "test_tracing_metric_" + name.replace(".", "_"))
    kind = "train" if name.endswith("train") or name.startswith("train") else "redock"
    base, program = _train_trace() if kind == "train" else _redock_trace()
    without = reader.read(_layer(kind, base))
    assert without is not None
    assert reader.read(_layer(kind, base + program)) == without
