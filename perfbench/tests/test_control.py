"""The comparison that decides `correct`, shown to fail: the control (the
plain reference a precision below the cell's, TF32 for the fp32 redocking
cells, fp8 for the bf16 training cell, standing in the program's place)
and each fault a cell can have, planted under a tiny CPU run, read above
the cell's limits, while the program reads below them.

Redocking faults: a denoiser step that returns its input unchanged; half
of the poses of a pass replaced by the mean of the other half; an answer
altered where it is produced (the trunk's pair tensor, the denoiser's
output, the guidance's relaxed ligand, the chirality verdicts); fewer
poses kept than the round protocol promises; ranked poses not written.
Training faults: a step that leaves the parameters unchanged, from the
first or only from the window's steps on; the loss taken over half of the
noised copies; the loss altered where it is produced. Every cell runs on one
card, so no exchange between cards can be left out."""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from perfbench.lib import harness
from perfbench.tests.test_harness import SEED, TINY

CONTROLS = {"redock.medium.b4": "tf32", "redock.full.b1": "tf32", "train.medium.bf16": "fp8"}


def readings(cell, precisions):
    c = harness.find_cell(cell)
    drv = c.traffic["driver"]
    ctx = harness.Context(c, SEED, 0, False, "cpu", 0.0, overrides=TINY[drv])
    driver = harness.load_module(f"{harness.ROOT}/perfbench/drivers/{drv}.py", "drv_" + drv)
    try:
        row = driver.readings(ctx, [SEED], precisions)[0]
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    return row, c.traffic["limits"]


@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_fails_where_the_program_passes(cell):
    control = CONTROLS[cell]
    row, limits = readings(cell, (control,))
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row
    assert any(row[control][k] > lim for k, lim in limits.items()), row


@contextlib.contextmanager
def patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _unchanged(orig):
    return lambda self, batch, x_hat, *a, **k: x_hat.clone()


def _half_from_mean(orig):
    def f(self, batch, x_hat, t_hat, *a, **k):
        out = orig(self, batch, x_hat, t_hat, *a, **k)
        n = out.shape[1] // 2
        out[:, n:] = out[:, :n].mean(1, keepdim=True)
        return out
    return f


def _denoiser_altered(orig):
    def f(self, *a, **k):
        out = orig(self, *a, **k)
        out[..., 0, 0] += 0.5
        return out
    return f


def _trunk_altered(orig):
    def f(self, batch):
        a, ap, s, z = orig(self, batch)
        z = z.clone()
        z[0, 0] += 0.1
        return a, ap, s, z
    return f


def _relax_altered(orig):
    def f(pos, ff, **k):
        out = orig(pos, ff, **k).clone()
        out[..., 0, :] += 1.0  # one atom: a rigid shift of all would align away
        return out
    return f


def _no_update(orig, after: int = 0):
    def f(self, grads, state):
        count = state.count
        updates, state = orig(self, grads, state)
        if count < after:
            return updates, state
        return {k: torch.zeros_like(v) for k, v in updates.items()}, state
    return f


def _no_update_in_window(orig):
    return _no_update(orig, after=3)  # the checked steps of set-up pass


def _verdicts_flipped(orig):
    return lambda pos, ff: ~orig(pos, ff)


def _one_pose_kept(orig):
    return lambda self: orig(self)[:1]


def _not_written(orig):
    return lambda *a, **k: None


def _loss_half(orig):
    def f(outputs, feats, cfg, sigma_data=16.0):
        n = outputs["x_denoised"].shape[0] // 2
        out = dict(outputs, x_denoised=outputs["x_denoised"][:n], t_hat=outputs["t_hat"][:n],
                   x_hat=outputs["x_hat"][:n])
        return orig(out, feats, cfg, sigma_data)
    return f


def _loss_altered(orig):
    def f(*a, **k):
        loss, logs = orig(*a, **k)
        return loss * 1.05, dict(logs, loss=logs["loss"] * 1.05)
    return f


TRAIN_FAULTS = {
    "state_unchanged": ("physdock_tpu_torch.train.optim:Optimizer", "update", _no_update),
    "state_unchanged_in_window": ("physdock_tpu_torch.train.optim:Optimizer", "update",
                                  _no_update_in_window),
    "half_the_copies": ("physdock_tpu_torch.train.step:", "physdock_loss", _loss_half),
    "loss_altered": ("physdock_tpu_torch.train.step:", "physdock_loss", _loss_altered),
}

FAULTS = {
    "step_unchanged": ("physdock_tpu_torch.model.physdock:PhysDock", "denoise", _unchanged),
    "half_from_mean": ("physdock_tpu_torch.model.physdock:PhysDock", "denoise", _half_from_mean),
    "denoiser_altered": ("physdock_tpu_torch.model.physdock:PhysDock", "denoise",
                         _denoiser_altered),
    "trunk_altered": ("physdock_tpu_torch.model.physdock:PhysDock", "conditioning",
                      _trunk_altered),
    "guidance_altered": ("physdock_tpu_torch.model.diffusion:", "relax_positions",
                         _relax_altered),
    "chirality_altered": ("physdock_tpu_torch.infer.pipeline:", "chirality_correct",
                          _verdicts_flipped),
    "one_pose_kept": ("physdock_tpu_torch.infer.rounds:RoundProtocol", "final_poses",
                      _one_pose_kept),
    "poses_not_written": ("physdock_tpu_torch.infer.writers:", "write_ligand_sdf",
                          _not_written),
}


def _planted(cell, where, attr, make):
    import importlib

    mod, cls = where.split(":")
    owner = importlib.import_module(mod)
    owner = getattr(owner, cls) if cls else owner
    c = harness.find_cell(cell)
    with patched(owner, attr, make):
        return harness.run_cell(c, SEED, 1, False, "cpu", overrides=TINY[c.traffic["driver"]])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(fault):
    out = _planted("redock.medium.b4", *FAULTS[fault])
    assert out["correct"] is False, out["checks"]
    assert np.isfinite(out["metrics"]["redock_poses_per_s"]["value"])


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_a_planted_training_fault_makes_the_run_incorrect(fault):
    out = _planted("train.medium.bf16", *TRAIN_FAULTS[fault])
    assert out["correct"] is False, out["checks"]
