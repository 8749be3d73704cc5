"""CPU smoke of the port's train-to-dock gate (`scripts/torch_overfit_gate.py`),
as the JAX package's `scripts/overfit_gate.py` has its CPU smoke: 4 steps
at crop 64/512 with 2 augmentation samples from random weights, then the
4 demo systems redocked with the EMA weights (1 round of 2 poses, 4
sampler steps), the gate file written to a temporary directory. Then a
second window to step 5 resumes from the first window's train state, on
the JAX gate's draws (`--draws jax`). The first run writes a checkpoint
at steps 3 and 4, the second one at its end. Between them, a window in a
directory of its own resumes from the first run's step-3 checkpoint on
the port's keyed draws and trains to step 4: with the first run's own
first 3 steps, a run in two windows.

Checked: the gate file holds `OVERFIT_GATE.json`'s keys with this run's
numbers (steps, crop, a result per system with its top-5 RMSDs, the pass
verdicts computed by the JAX gate's rule from them), the device and
compute dtype (fp32 on the CPU), the SHA-256 of the EMA `.npz` it wrote,
and one window record per run (with the host's cores); the second
window starts at step 4 and ends at 5 with the JAX draws in its recipe;
the metrics log holds one line per step. The run in two windows equals the one call bit for bit: every
loss term of step 4 and the EMA weights it writes.
"""

import hashlib
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_overfit_gate.py")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends: a train state or a
    checkpoint written here takes hundreds of MB, and pytest keeps the
    directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _gate():
    spec = importlib.util.spec_from_file_location("torch_overfit_gate", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gate_cpu_smoke_writes_the_gate_file_and_resumes(tmp_path):
    torch.set_num_threads(4)
    gate = _gate()
    out, gate_out = str(tmp_path / "work"), str(tmp_path / "gate.json")
    args = ["--device", "cpu", "--crop", "64", "--atom_crop", "512", "--aug", "2",
            "--dock_rounds", "1", "--dock_poses", "2", "--dock_steps", "4", "--ckpt_every", "3",
            "--out", out, "--gate_out", gate_out]
    res = gate.main(["--steps", "4", *args])
    with open(gate_out) as f:
        saved = json.load(f)
    with open(os.path.join(REPO, "OVERFIT_GATE.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(saved) and saved == json.loads(json.dumps(res))
    assert saved["steps"] == saved["steps_requested"] == 4
    assert (saved["crop"], saved["atom_crop"], saved["model"]) == (64, 512, "toy")
    assert saved["device"]["platform"] == "cpu" and saved["compute_dtype"] == "float32"
    assert len(saved["results"]) == 4
    for r in saved["results"].values():
        assert len(r["top5_rmsd"]) == 2 and r["top_rmsd"] == r["top5_rmsd"][0] and r["rounds"] == 1
    ok_top = all(r["top_rmsd"] < 2.0 for r in saved["results"].values())
    ok_top5 = all(max(r["top5_rmsd"]) < 2.0 for r in saved["results"].values())
    assert (saved["pass_top_ranked"], saved["pass_all_top5"], saved["pass"]) == (
        ok_top, ok_top5, ok_top and ok_top5)
    with open(os.path.join(out, "ema_params.npz"), "rb") as f:
        assert saved["ema_npz_sha256"] == hashlib.sha256(f.read()).hexdigest()
    assert [(w["start_step"], w["end_step"]) for w in saved["windows"]] == [(0, 4)]

    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == ["step_00000003.pt",
                                                             "step_00000004.pt"]
    with open(os.path.join(out, "scalars.jsonl")) as f:
        one_call = [json.loads(line) for line in f]
    with np.load(os.path.join(out, "ema_params.npz")) as z:
        one_call_ema = {k: z[k] for k in z.files}

    # the second window of the same 4 steps, from the first run's step 3
    out2 = str(tmp_path / "windows")
    os.makedirs(os.path.join(out2, "ckpts"))
    shutil.copy(os.path.join(out, "ckpts", "step_00000003.pt"), os.path.join(out2, "ckpts"))
    res2 = gate.main(["--steps", "4", *[a if a != out else out2 for a in args]])
    assert [(w["start_step"], w["end_step"]) for w in res2["windows"]] == [(3, 4)]
    assert all(w["nproc"] == os.cpu_count() for w in saved["windows"] + res2["windows"])
    with open(os.path.join(out2, "scalars.jsonl")) as f:
        windowed = [json.loads(line) for line in f]
    assert [r["step"] for r in one_call] == [1, 2, 3, 4]
    assert [r["step"] for r in windowed] == [4]
    for a, b in zip(one_call[3:], windowed):
        a.pop("time"), b.pop("time")
        assert a == b, (a, b)
    with np.load(os.path.join(out2, "ema_params.npz")) as z:
        assert sorted(z.files) == sorted(one_call_ema)
        for k in z.files:  # bit for bit
            assert z[k].tobytes() == one_call_ema[k].tobytes(), k
    assert res2["ema_npz_sha256"] == saved["ema_npz_sha256"]

    res = gate.main(["--steps", "5", "--draws", "jax", *args])
    assert [(w["start_step"], w["end_step"]) for w in res["windows"]] == [(0, 4), (4, 5)]
    assert res["steps"] == 5 and res["recipe"]["draws"] == "jax"
    with open(os.path.join(out, "scalars.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4, 5]
