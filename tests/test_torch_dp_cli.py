"""Data-parallel training of the PyTorch port on the CPU, without JAX: the
train step over two gloo ranks (`parallel/launch.run_ranks`) and the
train CLI in two processes.

  * the port's dp=2 step against its own dp=1 step on the same global
    batch of two synthetic systems, each drawing its noise from the
    streams keyed by one seed: every parameter, Adam moment and EMA tensor
    within rel 1e-6 (by tensor norm), the logs within rel 1e-6 (with the
    parity optimizer of tests/test_torch_dp.py);
  * the train CLI with --num_processes 2 (file:// rendezvous, gloo) for
    2 steps of a global batch of 2: both processes end cleanly, and rank 0
    alone writes the checkpoint and the metrics lines.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_ranks
from physdock_tpu_torch.data.synthetic import make_synthetic_batch
from physdock_tpu_torch.parallel.launch import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
DP, N_AUG = 2, 2
PARITY_OPT = dict(peak_lr=1e3, warmup_steps=1, eps=1.0)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends: a train state or a
    checkpoint written here takes hundreds of MB, and pytest keeps the
    directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _stack(singles):
    return {k: torch.from_numpy(np.stack([np.asarray(s[k]) for s in singles]))
            for k in singles[0]}


def test_dp2_step_equals_dp1_step(tmp_path):
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params
    from physdock_tpu_torch.train import optim
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    torch.set_num_threads(1)
    singles = [make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=s)
               for s in (0, 1)]
    path = os.path.join(tmp_path, "blob.pt")
    torch.save(dict(npz=NPZ, n_aug=N_AUG, opt=PARITY_OPT, ema_decay=0.5,
                    batch=_stack(singles), seed=11), path)
    ranks = run_ranks(torch_ranks.dp_step, DP, args=(path,), rdv_dir=str(tmp_path / "rdv"))

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=N_AUG)
    model = PhysDock(cfg.model)
    load_jax_params(model, NPZ)
    opt = optim.make_optimizer(**PARITY_OPT)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, cfg.loss, ema_decay=0.5, sigma_data=cfg.model.sigma_data)
    state, logs = step(state, _stack(singles), 11)
    want = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
            "ema": state.ema_params}
    for r in ranks:
        assert set(r["logs"]) == set(logs)
        for k, v in logs.items():
            assert abs(r["logs"][k] - v) <= 1e-6 * abs(v), (k, r["logs"][k], v)
        for q, tensors in want.items():
            for n, t in tensors.items():
                t = t.detach().float()
                diff = float((r[q][n].float() - t).norm())
                assert diff <= 1e-6 * float(t.norm()) + 1e-30, (q, n, diff, float(t.norm()))


def test_train_cli_two_processes_rank0_writes(tmp_path):
    data = tmp_path / "data" / "train_val"
    data.mkdir(parents=True)
    demo = os.path.join(REPO, "demo", "redocking", "Posebusters_subset")
    for name in ("5SD5_HWI_A_1.pkl.gz", "5SAK_ZRY_A_1.pkl.gz"):
        os.symlink(os.path.join(demo, name), data / name)
    out = tmp_path / "ckpt"
    url = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "physdock_tpu_torch.train.train", "--dataset_dir",
         str(data.parent), "-o", str(out), "--model_name", "toy", "--crop_size", "32",
         "--atom_crop_size", "256", "--num_augmentation_sample", "2", "--batch_size", "2",
         "--total_steps", "2", "--save_every", "2", "--device", "cpu", "--coordinator", url,
         "--num_processes", "2", "--process_id", str(i)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "step 2 loss" in logs[0] and "step 2 loss" not in logs[1], logs
    # one checkpoint and one metrics log (and rank 0's TensorBoard events
    # file, where tensorboard is installed)
    written = sorted(os.listdir(out))
    events = [f for f in written if f.startswith("events.out.tfevents")]
    assert len(events) <= 1 and sorted(set(written) - set(events)) == [
        "scalars.jsonl", "step_00000002.pt"], written
    lines = [json.loads(x) for x in open(out / "scalars.jsonl")]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines)
