"""The PyTorch port's training slice against the JAX package.

  * the training forward, the loss terms and every parameter's gradient,
    with the committed toy weights (`_overfit/ema_params.npz`) on
    conftest's `tiny_batch` (16 tokens, 48 atoms) and 2 augmentation
    samples: the JAX `model.apply(params, batch, key)` draws x_hat / t_hat,
    which the port takes through `PhysDock.forward_noised`;
  * the optimizer (global clip, Adam, schedule), the per-system clip and
    the EMA against the JAX package's optax chain over five steps;
  * one composed step of `train.step.make_train_step` at batch size 2
    against the JAX `make_train_step` (`step_parity`, which
    tests/test_torch_confidence.py also runs on the mini-rollout route):
    each system's x_hat and t_hat come from the JAX step's keys
    (`jax.random.fold_in(key, i)`) through the step's `draws` seam; the
    loss terms, and the change of the parameters, the Adam moments and the
    EMA, are compared.  Adam's eps is 1 there and the learning rate 1e3:
    with eps 1e-8 Adam's first update is lr * sign(g), which a rounding
    difference flips in any near-zero gradient entry; with eps 1 it is
    lr * g / (|g| + 1), linear in g, and a large lr lifts it far above the
    parameters' fp32 ulp, so every quantity compares at the gradient's
    limit (nu, quadratic in g, at twice it); the EMA decay is 0.5 for
    the same reason;
  * the train CLI on the CPU (toy preset, crop 32/256, 2 steps) with a
    checkpoint that restores, and its EMA exported as the JAX `.npz`
    layout and loaded by the JAX package;
  * the sampler's retry count and the prefetch thread's error hand-off.

Limits: x_denoised and p_distogram within rel 1e-3 of max|JAX| (fp32 on
the CPU, as tests/test_torch_model.py); the loss and each term within rel
1e-4.  Gradients: ||g_port - g_jax|| <= 1e-3 ||g_jax|| for every tensor
with ||g_jax|| > 1e-8, except seven whose true gradient is zero by
symmetry: each DiT attention's `norm_z.bias` adds a constant to a head's
logits, which softmax ignores, and `dit.norm_r.bias` translates every
atom of a sample, which the rigid-aligned and distance losses ignore.
Both frameworks give rounding noise there (~1e-7 against a global norm
||G|| ~ 43), so those must stay below 1e-6 ||G|| on both sides.
Optimizer state: max abs error <= 1e-6 of max|JAX| per tensor.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model.losses import physdock_loss as jax_physdock_loss
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.parallel.mesh import batch_sharding, make_mesh
from physdock_tpu.train import checkpoint as jax_ckpt
from physdock_tpu.train import optim as jax_optim
from physdock_tpu.train import step as jax_step
from physdock_tpu.utils.geometry import uniform_random_rotation as jax_rotation
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.losses import physdock_loss
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict, load_jax_params
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.train import checkpoint as ckpt
from physdock_tpu_torch.train import optim, train
from physdock_tpu_torch.train.sampler import WeightedSystemSampler, batch_iterator, prefetch
from physdock_tpu_torch.train.step import init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
DEMO = os.path.join(REPO, "demo", "redocking", "Posebusters_subset", "5SD5_HWI_A_1.pkl.gz")
REL_OUT, REL_LOSS, REL_GRAD, GRAD_FLOOR = 1e-3, 1e-4, 1e-3, 1e-6
ZERO_BY_SYMMETRY = re.compile(
    r"dit\.(atom_dit_encoder|token_dit|atom_dit_decoder)\.blocks\.\d+\.attention\.norm_z\.bias"
    r"|dit\.norm_r\.bias")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_run(tiny_batch):
    cfg = JaxConfig.named("toy", num_augmentation_sample=2)
    model = JaxPhysDock(cfg=cfg.model)
    params = jax_ckpt.load_params_npz(NPZ)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch.items()}

    def loss_fn(p):
        out = model.apply(p, batch, jax.random.PRNGKey(3))
        loss, logs = jax_physdock_loss(out, batch, cfg.loss, sigma_data=cfg.model.sigma_data)
        return loss, (out, logs)

    with jax.default_matmul_precision("highest"):
        (_, (out, logs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(grads).items()}
    return ({k: np.asarray(v) for k, v in out.items()}, {k: float(v) for k, v in logs.items()},
            jax_flat_to_state_dict(flat))


@pytest.fixture(scope="module")
def port_run(tiny_batch, jax_run):
    out_j = jax_run[0]
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    model = PhysDock(cfg.model)
    load_jax_params(model, NPZ)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in tiny_batch.items()}
    out = model.forward_noised(batch, torch.from_numpy(out_j["x_hat"]),
                               torch.from_numpy(out_j["t_hat"]))
    out.pop("conditioning")
    loss, logs = physdock_loss(out, batch, cfg.loss, sigma_data=cfg.model.sigma_data)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named, grads)}
    return ({k: v.detach().numpy() for k, v in out.items()},
            {k: float(v) for k, v in logs.items()}, grads)


def test_training_forward_matches_jax(jax_run, port_run):
    for name in ("x_denoised", "p_distogram"):
        ref, got = jax_run[0][name], port_run[0][name]
        assert ref.shape == got.shape, name
        err = np.abs(ref - got).max()
        assert err <= REL_OUT * np.abs(ref).max(), (name, err)


def test_training_loss_terms_match_jax(jax_run, port_run):
    ref, got = jax_run[1], port_run[1]
    assert set(ref) == set(got) and "loss" in got
    for name, r in ref.items():
        assert abs(got[name] - r) <= REL_LOSS * abs(r) + 1e-12, (name, got[name], r)


def test_training_gradients_match_jax(jax_run, port_run):
    ref, got = jax_run[2], port_run[2]
    assert set(ref) == set(got)
    total = np.sqrt(sum(float(np.sum(g.numpy().astype(np.float64) ** 2)) for g in ref.values()))
    worst, symmetric = (0.0, None), []
    for name, r in ref.items():
        r, g = r.numpy(), got[name].numpy()
        assert r.shape == g.shape, name
        nr = np.linalg.norm(r)
        if ZERO_BY_SYMMETRY.fullmatch(name):
            symmetric.append(name)
            assert max(nr, np.linalg.norm(g)) <= GRAD_FLOOR * total, (name, nr, np.linalg.norm(g))
        elif nr > 1e-8:
            worst = max(worst, (np.linalg.norm(g - r) / nr, name))
    print(f"worst gradient: {worst[1]} rel {worst[0]:.3e} (global norm {total:.3f})")
    assert len(symmetric) == 7, symmetric
    assert worst[0] <= REL_GRAD, worst


def test_forward_draws_its_noise_on_the_cpu_generator(tiny_batch):
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=3)
    model = PhysDock(cfg.model)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in tiny_batch.items()}
    x1, t1 = model.augmentation_diffuse(batch, torch.Generator().manual_seed(5))
    x2, t2 = model.augmentation_diffuse(batch, torch.Generator().manual_seed(5))
    assert torch.equal(x1, x2) and torch.equal(t1, t2)
    assert x1.shape == (3, 48, 3) and bool((t1 > 0).all())
    with torch.no_grad():
        out = model(batch, torch.Generator().manual_seed(5))
        ref = model.forward_noised(batch, x1, t1)
    assert torch.equal(out["x_hat"], x1)
    torch.testing.assert_close(out["x_denoised"], ref["x_denoised"], rtol=0, atol=0)


def test_loss_config_matches_jax_and_recycles_still_raise():
    """The loss config equals the JAX one; a recycling model (ported since,
    tests/test_torch_recycle.py) still raises on weights without its
    recycle tensors instead of keeping their zero init."""
    import dataclasses

    cfg = PhysDockConfig.named("medium", inference_mode=False, num_augmentation_sample=7)
    ref = JaxConfig.named("medium", inference_mode=False, num_augmentation_sample=7)
    assert dataclasses.asdict(cfg.loss) == dataclasses.asdict(ref.loss)
    assert cfg.model.num_augmentation_sample == 7 and not cfg.inference_mode
    toy = PhysDockConfig.named("toy").model
    with pytest.raises(KeyError, match="recycle_linear_s"):
        load_jax_params(PhysDock(dataclasses.replace(toy, num_recycles=1)), NPZ)


def test_schedule_matches_jax():
    ours = optim.stair_exp_warmup_schedule()
    ref = jax_optim.stair_exp_warmup_schedule()
    for step in (0, 999, 1000, 2500):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


def test_optimizer_clip_and_ema_match_optax():
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (5,)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    # raw norms from ~0.2 to ~80: the per-system clip and the global clip
    # both trigger on some steps
    steps = [{n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in shapes.items()}
             for scale in (0.05, 3.0, 20.0, 0.5, 8.0)]

    jopt = jax_optim.make_optimizer(peak_lr=1e-2, warmup_steps=2)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jstate, jema = jopt.init(jp), dict(jp)

    topt = optim.make_optimizer(peak_lr=1e-2, warmup_steps=2)
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    tstate, tema = topt.init(tp), {n: v.clone() for n, v in tp.items()}

    def close(ref, got, what):
        ref, got = np.asarray(ref), got.numpy()
        assert np.abs(ref - got).max() <= 1e-6 * np.abs(ref).max(), what

    for i, g in enumerate(steps):
        jg = {n: jnp.asarray(v) for n, v in g.items()}
        tg = {n: torch.from_numpy(v) for n, v in g.items()}
        if i % 2 == 0:
            jg, tg = jax_optim.clip_by_norm(jg, 0.1), optim.clip_by_norm(tg, 0.1)
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        jema = jax_optim.ema_update(jema, jp)
        tupd, tstate = topt.update(tg, tstate)
        for n in tp:
            tp[n] += tupd[n]
        optim.ema_update(tema, tp)
        adam = jstate[1]
        assert tstate.count == int(adam.count)
        for n in shapes:
            close(jp[n], tp[n], (i, "params", n))
            close(adam.mu[n], tstate.mu[n], (i, "mu", n))
            close(adam.nu[n], tstate.nu[n], (i, "nu", n))
            close(jema[n], tema[n], (i, "ema", n))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    data = root / "data" / "train_val"
    data.mkdir(parents=True)
    os.symlink(DEMO, data / os.path.basename(DEMO))
    out = root / "ckpt"
    _flash_lib.reset_launches()
    summary = train.main([
        "--dataset_dir", str(root / "data"), "-o", str(out), "--model_name", "toy",
        "--crop_size", "32", "--atom_crop_size", "256", "--num_augmentation_sample", "2",
        "--total_steps", "2", "--save_every", "2", "--seed", "1", "--device", "cpu",
    ])
    return summary, out


def test_train_cli_cpu_runs_and_checkpoint_restores(cli_run):
    summary, out = cli_run
    assert summary["device"] == "cpu" and summary["steps"] == [1, 2]
    assert summary["retries"] == 0
    assert all(n == 0 for n in _flash_lib.LAUNCHES.values())
    for logs in summary["logs"]:
        assert set(logs) >= {"loss", "weighted_mse_loss", "distogram_loss"}
        assert all(np.isfinite(v) for v in logs.values()), logs
    path = str(out / "step_00000002.pt")
    assert summary["checkpoints"] == [path] and ckpt.latest_checkpoint(str(out)) == path

    state = summary["state"]
    fresh = PhysDock(PhysDockConfig.named("toy", num_augmentation_sample=2).model)
    opt = optim.make_optimizer()
    restored = ckpt.restore_train_state(path, init_train_state(fresh, opt))
    assert restored.step == 2 and restored.opt_state.count == 2
    for tree in ("params", "ema_params"):
        for n, t in getattr(state, tree).items():
            assert torch.equal(getattr(restored, tree)[n], t.detach()), (tree, n)
    for n, t in state.opt_state.nu.items():
        assert torch.equal(restored.opt_state.nu[n], t)
    moved = sum(float((state.params[n] - state.ema_params[n]).abs().sum()) for n in state.params)
    assert moved > 0


def test_ema_npz_loads_into_jax(cli_run, tiny_batch, tmp_path):
    summary, _ = cli_run
    ema = summary["state"].ema_params
    path = str(tmp_path / "ema.npz")
    ckpt.save_params_npz(path, ema)
    back = ckpt.load_params_npz(path)
    assert set(back) == set(ema)
    for n, t in ema.items():  # fp16 storage: within its rounding
        assert float((back[n] - t).abs().max()) <= 1e-3 * float(t.abs().max()) + 1e-7, n

    jparams = jax_ckpt.load_params_npz(path)
    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch.items()}
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(jparams, batch, method="conditioning")
    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, path)
    with torch.no_grad():
        got = model.conditioning({k: torch.from_numpy(np.asarray(v)) for k, v in tiny_batch.items()})
    for name, r, g in zip(("a", "ap", "s", "z"), ref, got):
        r = np.asarray(r)
        assert np.abs(r - g.numpy()).max() <= REL_OUT * np.abs(r).max(), name


def test_sampler_counts_and_prints_retries(tmp_path, capsys):
    from physdock_tpu_torch.config import DataConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer

    bad = tmp_path / "bad.pkl.gz"
    bad.write_bytes(b"not a system")

    class BadFirst(WeightedSystemSampler):
        def __iter__(self):
            yield str(bad)
            while True:
                yield DEMO

    sampler = BadFirst([str(bad), DEMO])
    feats = SystemFeaturizer(DataConfig(crop_size=32, atom_crop_size=256), inference_mode=False,
                             seed=0, pad_to_bucket=False)
    batch = next(batch_iterator(sampler, feats, 1, 32, 256))
    assert batch["s_mask"].shape == (1, 32) and batch["a_mask"].shape == (1, 256)
    assert sampler.retries == 1
    assert "retry 1 on another system" in capsys.readouterr().out


def test_prefetch_raises_the_producer_error():
    def produce():
        yield 1
        raise ValueError("featurizer broke")

    it = prefetch(produce())
    assert next(it) == 1
    with pytest.raises(ValueError, match="featurizer broke"):
        next(it)


def _flat(tree):
    return jax_flat_to_state_dict({"/".join(k): np.asarray(v)
                                   for k, v in flatten_dict(tree).items()})


def _jax_draws(jm, params, singles, key, corrupt):
    """Each system's draws as the JAX step makes them: x_hat and t_hat from
    `fold_in(key, i)` (its first split under the mini-rollout), and the
    corrupt pose's five draws from the second split."""
    draws = []
    for i, single in enumerate(singles):
        micro = {k: jnp.asarray(v) for k, v in single.items()}
        k_fwd = jax.random.fold_in(key, i)
        if corrupt:
            k_fwd, k_roll = jax.random.split(k_fwd)
        x_hat, t_hat = jm.apply(params, micro, k_fwd, method="augmentation_diffuse")
        d = {"x_hat": torch.from_numpy(np.array(x_hat)),
             "t_hat": torch.from_numpy(np.array(t_hat))}
        if corrupt:
            k_m, k_dir, k_rot, k_jl, k_jr = jax.random.split(k_roll, 5)
            shape = micro["x_gt"].shape
            d["corrupt"] = {k: torch.from_numpy(np.array(v)) for k, v in {
                "u": jax.random.uniform(k_m), "direction": jax.random.normal(k_dir, (3,)),
                "rot": jax_rotation(k_rot, ()), "jitter_lig": jax.random.normal(k_jl, shape),
                "jitter_rec": jax.random.normal(k_jr, shape)}.items()}
        draws.append(d)
    return draws


def step_parity(npz, singles, with_confidence=False, loss_overrides=None, n_aug=2, seed=7):
    """One train step at batch size len(singles), JAX and port, from the
    same weights and draws; returns (jax logs, port logs, {quantity: (JAX
    change, port change)}) with the changes of params, mu, nu and EMA as
    state_dicts. With the head, the step runs the mini-rollout on the
    corrupt-pose route."""
    import dataclasses

    jcfg = JaxConfig.named("toy", num_augmentation_sample=n_aug)
    jloss = dataclasses.replace(jcfg.loss, **(loss_overrides or {}))
    jm = JaxPhysDock(cfg=jcfg.model, with_confidence=with_confidence)
    params = jax_ckpt.load_params_npz(npz)
    p0 = _flat(params)
    key = jax.random.PRNGKey(seed)
    stacked = {k: np.stack([np.asarray(s[k]) for s in singles]) for k in singles[0]}
    draws = _jax_draws(jm, params, singles, key, with_confidence)
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jopt = jax_optim.make_optimizer(peak_lr=1e3, warmup_steps=1, eps=1.0)
    jstep = jax_step.make_train_step(
        jm, jopt, jloss, mesh, ema_decay=0.5, sigma_data=jcfg.model.sigma_data,
        use_mini_rollout=with_confidence, corrupt_rollout_pose=with_confidence)
    jbatch = jax.device_put({k: jnp.asarray(v) for k, v in stacked.items()},
                            batch_sharding(mesh))
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = jstep(jax_step.init_train_state(params, jopt), jbatch, key)
    adam = jstate.opt_state[1]
    ref = {"params": _flat(jstate.params), "mu": _flat(adam.mu), "nu": _flat(adam.nu),
           "ema": _flat(jstate.ema_params)}
    assert int(jstate.step) == 1 and int(adam.count) == 1

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=n_aug)
    model = PhysDock(cfg.model, with_confidence=with_confidence)
    load_jax_params(model, npz)
    topt = optim.make_optimizer(peak_lr=1e3, warmup_steps=1, eps=1.0)
    state = init_train_state(model, topt)
    step = make_train_step(model, topt, dataclasses.replace(cfg.loss, **(loss_overrides or {})),
                           ema_decay=0.5, sigma_data=cfg.model.sigma_data,
                           use_mini_rollout=with_confidence,
                           corrupt_rollout_pose=with_confidence)
    state, logs = step(state, {k: torch.from_numpy(v) for k, v in stacked.items()},
                       draws=draws)
    assert state.step == 1 and state.opt_state.count == 1
    got = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
           "ema": state.ema_params}
    changes = {}
    for q in ref:
        base = p0 if q in ("params", "ema") else {n: torch.zeros_like(t) for n, t in p0.items()}
        assert set(ref[q]) == set(got[q]) == set(base), q
        changes[q] = ({n: ref[q][n] - base[n] for n in base},
                      {n: got[q][n].detach().float() - base[n] for n in base})
    return {k: float(v) for k, v in jlogs.items()}, logs, changes


def check_step_parity(jlogs, logs, changes):
    """Loss terms within REL_LOSS; the change of each quantity within
    REL_GRAD (nu 2 * REL_GRAD) of its norm over all tensors, and per tensor
    except the zero-by-symmetry ones, which stay below GRAD_FLOOR of the
    global norm on both sides."""
    assert set(jlogs) == set(logs)
    for name, r in jlogs.items():
        assert abs(logs[name] - r) <= REL_LOSS * abs(r) + 1e-12, (name, logs[name], r)
    for q, (ref, got) in changes.items():
        rel = 2 * REL_GRAD if q == "nu" else REL_GRAD
        total = np.sqrt(sum(float((r.double() ** 2).sum()) for r in ref.values()))
        diff = np.sqrt(sum(float(((got[n] - r).double() ** 2).sum()) for n, r in ref.items()))
        assert diff <= rel * total, (q, diff, total)
        worst = (0.0, None)
        for n, r in ref.items():
            nr, ng = float(r.norm()), float(got[n].norm())
            if ZERO_BY_SYMMETRY.fullmatch(n):
                assert max(nr, ng) <= GRAD_FLOOR * total, (q, n, nr, ng)
            elif nr > GRAD_FLOOR * total:
                worst = max(worst, (float((got[n] - r).norm()) / nr, n))
        print(f"{q}: global rel {diff / total:.3e}, worst tensor {worst[1]} rel {worst[0]:.3e}")
        assert worst[0] <= rel, (q, worst)


def test_train_step_batch2_matches_jax_step():
    singles = [make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=s)
               for s in (0, 1)]
    check_step_parity(*step_parity(NPZ, singles))
