"""The benchmark harness on the CPU at a tiny size: the result line, a cell
added from new files alone, what a run loads, and the analytic FLOP
count. The card's runs are `test_card_run` (marker `gpu`).

    python -m pytest perfbench/tests -q -p no:cacheprovider
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import harness

ROOT = harness.ROOT
TOY = {"preset": "toy", "no_blocks_atom": 2, "no_blocks_evoformer": 2,
       "no_blocks_pairformer": 2, "no_blocks_dit": 2, "no_blocks_heads": 2}
FLAGS = ["--crop_size", "64", "--atom_crop_size", "512", "--steps", "3", "--max_rounds", "2",
         "--num_samples_per_round", "2", "--max_samples", "4", "--num_confs", "4",
         "--use_pocket", "--use_key_res", "--enable_physics_correction", "--enable_ranking"]
TINY = {"redock": {"config": TOY, "params": {"flags": FLAGS, "warmup_steps": 2}},
        "train": {"config": TOY, "params": {"crop": 64, "atom_crop": 512, "augmentation": 2,
                                            "reference_chunk": 2}}}
SEED = 2 ** 33 + 17
E2E = {"redock": "redock_poses_per_s", "train": "train_step_s"}


def tiny_run(cell, trace=False, root=ROOT, seed=SEED):
    c = harness.find_cell(cell, root)
    return harness.run_cell(c, seed, 1, trace, "cpu", overrides=TINY[c.traffic["driver"]])


def check_line(out, cell):
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(out)[-1] == "checks", "the numbers compared come last"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    dev = out["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    json.loads(json.dumps(out))


@pytest.mark.parametrize("cell", ["redock.medium.b4", "train.medium.bf16", "redock.full.b1"])
def test_tiny_run_prints_a_result_line(cell):
    out = tiny_run(cell)
    check_line(out, cell)
    e2e = E2E[harness.find_cell(cell).traffic["driver"]]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {e2e, "setup_s"}
    assert out["metrics"][e2e]["value"] > 0


@pytest.mark.parametrize("cell,host_metric", [("redock.medium.b4", "featurize.load_s.redock"),
                                              ("train.medium.bf16", "train.data_wait_ms")])
def test_traced_tiny_run_reads_per_layer_metrics(cell, host_metric):
    out = tiny_run(cell, trace=True)
    check_line(out, cell)
    # no device on the CPU: the readers of device time find nothing, and
    # the host's share is there
    assert host_metric in out["metrics"]
    assert not any(k.startswith("mfu") or "roofline" in k for k in out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def test_a_cell_from_new_files_alone_is_found(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new BENCHMARK.json entries, nothing edited."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    conf = json.load(open(os.path.join(ROOT, "perfbench/configs/physdock-medium.json")))
    conf.update(TOY, name="physdock-toy")
    json.dump(conf, open(os.path.join(root, "perfbench/configs/physdock-toy.json"), "w"))
    traffic = json.load(open(os.path.join(ROOT, "perfbench/workloads/redock.b4.json")))
    traffic["params"].update(batch_size=2, flags=FLAGS, warmup_steps=2)
    json.dump(traffic, open(os.path.join(root, "perfbench/workloads/redock.b2.json"), "w"))
    with open(os.path.join(root, "perfbench/metrics/post.host_s.redock.py"), "w") as f:
        f.write('def read(run):\n    return run["spans"].host_s.get("post")\n')
    bench["configs"].append({"name": "physdock-toy", "source": "https://example.org/toy",
                             "file": "perfbench/configs/physdock-toy.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "redock.toy.b2", "config": "physdock-toy",
                               "traffic": "redock.b2", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "redock.medium.b4" in m["workloads"]:
            m["workloads"].append("redock.toy.b2")
    bench["per_layer"].append({"name": "post.host_s.redock", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "post-processing",
                               "moves": "redock_poses_per_s", "workloads": ["redock.toy.b2"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = harness.find_cell("redock.toy.b2", root)
    assert cell.config["preset"] == "toy" and cell.traffic["params"]["batch_size"] == 2
    assert "post.host_s.redock" in cell.layer
    out = harness.run_cell(cell, SEED, 1, True, "cpu")
    assert out["correct"] and out["metrics"]["post.host_s.redock"]["value"] > 0


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from perfbench.lib import harness\n"
        "from perfbench.tests.test_harness import tiny_run\n"
        "out = tiny_run('redock.medium.b4')\n"
        "print(json.dumps([harness.forbidden_modules(), out['correct']]))\n" % ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    bad, correct = json.loads(res.stdout.strip().splitlines()[-1])
    assert bad == [] and correct


def test_whole_name_match(monkeypatch):
    """The port's name begins with the JAX package's: names match whole."""
    import types

    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "physdock_tpu_torchx", types.ModuleType("a"))
    monkeypatch.setitem(sys.modules, "jaxlibrary.sub", types.ModuleType("b"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "physdock_tpu.config", types.ModuleType("c"))
    assert "physdock_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "perfbench", "reference", "*.py")):
        got = set(_imports(path))
        assert not got & {"jax", "jaxlib", "flax", "physdock_tpu", "physdock_tpu_torch"}, path


def test_nothing_in_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "perfbench", "**", "*.py"), recursive=True):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "physdock_tpu"}, path


def test_no_card_no_result(tmp_path):
    """Without a card the entry exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "redock.medium.b4", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ gives no result."""
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "redock.medium.b4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["redock.medium.b4", "train.medium.bf16", "redock.full.b1"])
def test_card_run(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    check_line(out, cell)
    assert out["correct"], out["checks"]
