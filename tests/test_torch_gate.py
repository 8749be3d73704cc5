"""CPU smoke of the port's train-to-dock gate (`scripts/torch_overfit_gate.py`),
as the JAX package's `scripts/overfit_gate.py` has its CPU smoke: 4 steps
at crop 64/512 with 2 augmentation samples from random weights, then the
4 demo systems redocked with the EMA weights (1 round of 2 poses, 4
sampler steps), the gate file written to a temporary directory. Then a
second window to step 5 resumes from the first window's train state.

Checked: the gate file holds `OVERFIT_GATE.json`'s keys with this run's
numbers (steps, crop, a result per system with its top-5 RMSDs, the pass
verdicts computed by the JAX gate's rule from them), the device and
compute dtype (fp32 on the CPU), the SHA-256 of the EMA `.npz` it wrote,
and one window record per run; the second window starts at step 4 and
ends at 5; the metrics log holds one line per step.
"""

import hashlib
import importlib.util
import json
import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_overfit_gate.py")


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
            "--dock_rounds", "1", "--dock_poses", "2", "--dock_steps", "4", "--ckpt_every", "2",
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

    res = gate.main(["--steps", "5", *args])
    assert [(w["start_step"], w["end_step"]) for w in res["windows"]] == [(0, 4), (4, 5)]
    assert res["steps"] == 5
    with open(os.path.join(out, "scalars.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4, 5]
