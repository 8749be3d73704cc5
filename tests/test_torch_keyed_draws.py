"""Keyed training draws (`physdock_tpu_torch/train/draws.py`) through the
port's train step, on the CPU, without JAX.

Each system's draws come from streams keyed by (run seed, step, global
system index, purpose), as the JAX step folds the global index into the
step's key and splits it into the forward's and the rollout's keys.
Checked, with the step's streams and its forward's inputs recorded:

  * the 64-bit stream seeds of distinct keys differ (among them the
    pair that the gate's former affine seed made equal), and one key
    gives one stream;
  * a system's x_hat and t_hat are bit for bit the same whatever the
    other systems of the batch are and whatever this rank's n_local and
    the dp layout are (dp=1 with two systems, against a dp=2 rank 1
    holding one);
  * a dp rank draws for its own systems only (the streams it opens and
    the forwards it runs);
  * two (step, system) pairs give different draws;
  * the forward's draws do not depend on whether the step runs a
    mini-rollout; the rollout's and the corruption's draws come from
    their own streams.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.synthetic import make_synthetic_batch
from physdock_tpu_torch.model.physdock import PhysDock, prepare_batch
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.parallel.mesh import Mesh
from physdock_tpu_torch.train import draws as keyed
from physdock_tpu_torch.train import optim
from physdock_tpu_torch.train.corrupt import corrupt_pose_draws
from physdock_tpu_torch.train.step import init_train_state, make_train_step, rollout_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
SEED, STEP = 11, 5


def _system(seed):
    single = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=seed)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in single.items()}


def _stack(systems):
    return {k: torch.stack([s[k] for s in systems]) for k in systems[0]}


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    m = PhysDock(PhysDockConfig.named("toy", num_augmentation_sample=2).model)
    load_jax_params(m, NPZ)
    return m


def test_stream_seeds_differ_by_every_part_of_the_key():
    keys = [(s, st, i, p) for s in (0, 1) for st in (0, 1, 1_000_003) for i in (0, 1, 2)
            for p in keyed.PURPOSES]
    assert len({keyed.stream_seed(*k) for k in keys}) == len(keys)
    # seed 1 from step 0 and seed 0 from step 1,000,003 shared one stream
    assert keyed.stream_seed(1, 0, 0, "forward") != keyed.stream_seed(0, 1_000_003, 0, "forward")
    a = torch.randn(8, generator=keyed.stream(3, 5, 7, "rollout"))
    assert torch.equal(a, torch.randn(8, generator=keyed.stream(3, 5, 7, "rollout")))


def _run(model, monkeypatch, systems, mesh=None, step=STEP):
    """One train step on `systems` (this rank's); the streams it opened
    and each forward's (x_gt, x_hat, t_hat)."""
    opened, forwards = [], []
    real_stream = keyed.stream

    def stream(*key):
        opened.append(key)
        return real_stream(*key)

    def forward_noised(micro, x_hat, t_hat):
        forwards.append((micro["x_gt"].clone(), x_hat.clone(), t_hat.clone()))
        return real_forward(micro, x_hat, t_hat)

    real_forward = model.forward_noised
    monkeypatch.setattr(keyed, "stream", stream)
    monkeypatch.setattr(model, "forward_noised", forward_noised)
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    opt = optim.make_optimizer()
    state = dataclasses.replace(init_train_state(model, opt), step=step)
    train_step = make_train_step(model, opt, cfg.loss, sigma_data=cfg.model.sigma_data,
                                 mesh=mesh)
    with torch.no_grad():
        saved = {n: p.clone() for n, p in model.named_parameters()}
    try:
        train_step(state, _stack(systems), SEED)
    finally:
        with torch.no_grad():  # the step updates the model's own parameters
            for n, p in model.named_parameters():
                p.copy_(saved[n])
        monkeypatch.undo()
    return opened, forwards


def test_a_systems_draws_depend_only_on_its_key(model, monkeypatch):
    s0, s1, s2 = (_system(s) for s in (0, 1, 2))
    opened, ref = _run(model, monkeypatch, [s0, s1])
    assert opened == [(SEED, STEP, 0, "forward"), (SEED, STEP, 1, "forward")]

    # another system before it: system 1 draws the same; slot 0 the same
    # noise level
    _, other = _run(model, monkeypatch, [s2, s1])
    assert torch.equal(other[1][1], ref[1][1]) and torch.equal(other[1][2], ref[1][2])
    assert torch.equal(other[0][2], ref[0][2]) and not torch.equal(other[0][1], ref[0][1])

    # dp=2, rank 1 holding system 1 alone (n_local 1): its own system only,
    # drawn as at dp=1
    opened, rank1 = _run(model, monkeypatch, [s1], mesh=Mesh(dp=2, tp=1, dp_rank=1))
    assert opened == [(SEED, STEP, 1, "forward")] and len(rank1) == 1
    assert torch.equal(rank1[0][0], ref[1][0])
    assert torch.equal(rank1[0][1], ref[1][1]) and torch.equal(rank1[0][2], ref[1][2])


def test_distinct_steps_and_systems_draw_differently(model):
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    step = make_train_step(model, optim.make_optimizer(), cfg.loss)
    m = prepare_batch(_system(1))
    draws = {(st, i): step.draw_system(m, SEED, st, i) for st in (STEP, STEP + 1) for i in (0, 1)}
    for a in draws:
        for b in draws:
            if a < b:
                assert not torch.equal(draws[a]["t_hat"], draws[b]["t_hat"]), (a, b)
                assert not torch.equal(draws[a]["x_hat"], draws[b]["x_hat"]), (a, b)
    again = step.draw_system(m, SEED, STEP, 1)
    assert torch.equal(again["x_hat"], draws[(STEP, 1)]["x_hat"])


def test_rollout_and_corruption_draw_from_their_own_streams(model):
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    opt = optim.make_optimizer()
    m = prepare_batch(_system(1))
    n_atoms = m["x_gt"].shape[-2]
    plain = make_train_step(model, opt, cfg.loss).draw_system(m, SEED, STEP, 1)
    mini = make_train_step(model, opt, cfg.loss, use_mini_rollout=True,
                           mini_rollout_steps=3).draw_system(m, SEED, STEP, 1)
    corrupt = make_train_step(model, opt, cfg.loss, use_mini_rollout=True,
                              corrupt_rollout_pose=True).draw_system(m, SEED, STEP, 1)
    for d in (mini, corrupt):
        assert torch.equal(d["x_hat"], plain["x_hat"]) and torch.equal(d["t_hat"], plain["t_hat"])
    want = rollout_draws(keyed.stream(SEED, STEP, 1, "rollout"), n_atoms, 3)
    assert set(mini["rollout"]) == set(want)
    assert all(torch.equal(mini["rollout"][k], v) for k, v in want.items())
    want = corrupt_pose_draws(keyed.stream(SEED, STEP, 1, "corrupt"), n_atoms)
    assert all(torch.equal(corrupt["corrupt"][k], v) for k, v in want.items())
    assert not torch.equal(mini["rollout"]["x_init_z"][0], corrupt["corrupt"]["jitter_lig"])


def test_train_step_needs_a_seed_or_draws(model):
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    opt = optim.make_optimizer()
    step = make_train_step(model, opt, cfg.loss)
    with pytest.raises(ValueError, match="seed"):
        step(init_train_state(model, opt), _stack([_system(0)]))
