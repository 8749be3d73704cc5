"""The PyTorch port's confidence slice against the JAX package, with the
committed confidence weights (`_confidence/ema_params_conf.npz`: the toy
preset at full widths with a 2-block head, 31.8 M parameters).

  * `ConfidenceModule` on a synthetic batch of 32 tokens and 128 atoms, 8
    and 32 of them padding, against JAX `model.apply(..., method=
    "confidence")` on the same (s, z) and pose: the logits within rel 1e-3
    of max|JAX| (fp32 on the CPU, as tests/test_torch_model.py);
  * `plddt_loss`, `pde_loss`, `pae_loss`, `clamp_distance_loss` and
    `rffold_loss(use_mini_rollout=True)` on the same logits and poses:
    within rel 1e-4 (REL_LOSS of tests/test_torch_train.py);
  * `corrupt_pose_from_draws` fed the JAX key split's draws: within 1e-5 A;
  * `_confidence_scores` of both pipelines on the same poses, each
    package's own trunk included: ptm, iptm and ranking_confidence within
    1e-4 abs, mean_plddt within 1e-2;
  * the weight bridge both ways with every key used once, and the
    head-less load's 93 leftover head arrays;
  * the redocking and screening CLIs on the CPU with the confidence
    flags, writing `confidence.json`; the batched screen scores none;
  * the `ValueError` when the flags meet a head-less model;
  * the config's presets and loss fields against the JAX package's;
  * the train CLI with `--use_mini_rollout` on the CPU: the head in the
    optimizer, EMA, checkpoint and exported `.npz`;
  * one mini-rollout train step at batch size 2, on the corrupt-pose
    route, against the JAX step (`test_torch_train.step_parity`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import REL_LOSS, check_step_parity, step_parity

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.infer.pipeline import DockingPipeline as JaxPipeline
from physdock_tpu.infer.pipeline import SamplerSettings as JaxSettings
from physdock_tpu.model import losses as jlosses
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu.train.corrupt import corrupt_pose as jax_corrupt_pose
from physdock_tpu.utils.geometry import uniform_random_rotation as jax_rotation
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings
from physdock_tpu_torch.model import losses
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import (
    jax_flat_to_state_dict,
    load_jax_params,
    load_npz,
    state_dict_to_jax_flat,
)
from physdock_tpu_torch.train.corrupt import (
    corrupt_pose,
    corrupt_pose_draws,
    corrupt_pose_from_draws,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_confidence", "ema_params_conf.npz")
TOY_NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
REL = 1e-3
HEAD_KEYS, HEAD_PARAMS = 93, 8412914


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(2)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def batch():
    # 24 tokens and 96 atoms, padded to 32 and 128
    return make_synthetic_batch(n_tokens=24, n_atoms=96, n_msa=4, n_ligand_tokens=6, seed=3,
                                pad_tokens=8, pad_atoms=32)


@pytest.fixture(scope="module")
def poses(batch):
    """Three poses around the GT, 0.3, 2 and 6 A of noise: their labels
    and errors span the bins."""
    rng = np.random.default_rng(0)
    x_gt = np.asarray(batch["x_gt"], np.float32)
    return np.stack([x_gt + rng.normal(size=x_gt.shape) * s for s in (0.3, 2.0, 6.0)]
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    return JaxPhysDock(cfg=JaxConfig.named("toy").model, with_confidence=True), \
        load_params_npz(NPZ)


@pytest.fixture(scope="module")
def port_model():
    model = PhysDock(PhysDockConfig.named("toy").model, with_confidence=True)
    load_jax_params(model, NPZ)
    return model.eval()


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel_close(ref, out, rel=REL):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape
    err = np.abs(ref - out).max()
    assert err <= rel * np.abs(ref).max(), f"max abs err {err} vs max|ref| {np.abs(ref).max()}"


@pytest.fixture(scope="module")
def jax_head(jax_model, batch, poses):
    jm, jp = jax_model
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        a, ap, s, z = jm.apply(jp, jb, method="conditioning")
        logits = jm.apply(jp, jb, s, z, jnp.asarray(poses[1:]), method="confidence")
    return (np.array(s), np.array(z)), [np.array(x) for x in logits]


def test_batch_has_padded_tokens(batch):
    assert batch["s_mask"].shape == (32,) and float(np.sum(batch["s_mask"])) == 24
    assert batch["a_mask"].shape == (128,) and float(np.sum(batch["a_mask"])) == 96


def test_confidence_module_matches_jax(jax_head, port_model, batch, poses):
    (s, z), ref = jax_head
    with torch.no_grad():
        got = port_model.confidence(_tb(batch), torch.from_numpy(s), torch.from_numpy(z),
                                    torch.from_numpy(poses[1:]))
    for name, r, g in zip(("p_pae", "p_pde", "p_plddt"), ref, got):
        assert g.dtype == torch.float32, name
        _rel_close(r, g.numpy())


def test_confidence_losses_match_jax(jax_head, batch, poses):
    _, (p_pae, p_pde, p_plddt) = jax_head
    tb = _tb(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x_pred = poses[1:2]
    centres = {"token_id_to_centre_atom_id": "token_id_to_centre_atom_id"}
    frames = {f"token_id_to_frame_atom_id_{i}": f"token_id_to_frame_atom_id_{i}"
              for i in range(3)}
    cases = {
        "plddt": (jlosses.plddt_loss, losses.plddt_loss, p_plddt,
                  dict(no_bins=50), dict(is_dna="is_dna", is_rna="is_rna",
                                         is_ligand="is_ligand", **centres)),
        "pde": (jlosses.pde_loss, losses.pde_loss, p_pde, dict(), centres),
        "pae": (jlosses.pae_loss, losses.pae_loss, p_pae, dict(), dict(**centres, **frames)),
    }
    for name, (jf, tf, logits, kw, feat_kw) in cases.items():
        ref = float(jf(jnp.asarray(logits), jnp.asarray(x_pred), jb["x_gt"], jb["x_exists"],
                       **kw, **{k: jb[v] for k, v in feat_kw.items()}))
        got = float(tf(torch.from_numpy(logits), torch.from_numpy(x_pred), tb["x_gt"],
                       tb["x_exists"], **kw, **{k: tb[v] for k, v in feat_kw.items()}))
        assert ref > 0 and abs(got - ref) <= REL_LOSS * abs(ref), (name, got, ref)
    ref = float(jlosses.clamp_distance_loss(jnp.asarray(poses), jb["x_gt"], jb["x_exists"]))
    got = float(losses.clamp_distance_loss(torch.from_numpy(poses), tb["x_gt"], tb["x_exists"]))
    assert abs(got - ref) <= REL_LOSS * abs(ref), ("clamp_distance", got, ref)


def test_express_coordinates_in_frame_matches_jax(batch, poses):
    ids = np.stack([np.asarray(batch[f"token_id_to_frame_atom_id_{i}"]) for i in range(3)], -1)
    x = poses[2]
    ref, ref_valid = jlosses.express_coordinates_in_frame(jnp.asarray(x), jnp.asarray(x[ids]))
    got, valid = losses.express_coordinates_in_frame(torch.from_numpy(x),
                                                     torch.from_numpy(x[ids]))
    assert np.array_equal(np.asarray(ref_valid), valid.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_rffold_loss_matches_jax(jax_head, batch, poses):
    _, (p_pae, p_pde, p_plddt) = jax_head
    rng = np.random.default_rng(4)
    x_gt = np.asarray(batch["x_gt"], np.float32)
    outputs = {
        "x_denoised": (x_gt[None] + rng.normal(size=(2,) + x_gt.shape)).astype(np.float32),
        "t_hat": np.array([2.0, 30.0], np.float32),
        "p_distogram": rng.normal(size=(32, 32, 39)).astype(np.float32),
        "x_pred": poses[:1], "p_pae": p_pae, "p_pde": p_pde, "p_plddt": p_plddt,
    }
    jcfg = JaxConfig.named("toy").loss
    cfg = PhysDockConfig.named("toy").loss
    import dataclasses

    jcfg, cfg = (dataclasses.replace(c, alpha_pae=1.0) for c in (jcfg, cfg))
    _, ref = jlosses.rffold_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                                 {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                                 use_mini_rollout=True)
    _, got = losses.rffold_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                                _tb(batch), cfg, use_mini_rollout=True)
    assert set(ref) == set(got) and {"plddt_loss", "pae_loss", "pde_loss"} <= set(got)
    for name, r in ref.items():
        r = float(r)
        assert abs(float(got[name]) - r) <= REL_LOSS * abs(r) + 1e-12, (name, float(got[name]), r)
    # without the mini-rollout the aggregate is the release set
    _, plain = losses.rffold_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                                  _tb(batch), cfg)
    assert "plddt_loss" not in plain


def test_corrupt_pose_matches_jax_draws(batch):
    x_gt = np.asarray(batch["x_gt"], np.float32)
    a_mask = np.asarray(batch["a_mask"], np.float32)
    is_lig = (np.asarray(batch["is_ligand"])[np.asarray(batch["atom_id_to_token_id"])]
              * a_mask).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax_corrupt_pose(key, jnp.asarray(x_gt), jnp.asarray(a_mask),
                                          jnp.asarray(is_lig)))
        k_m, k_dir, k_rot, k_jl, k_jr = jax.random.split(key, 5)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in {
            "u": jax.random.uniform(k_m), "direction": jax.random.normal(k_dir, (3,)),
            "rot": jax_rotation(k_rot, ()), "jitter_lig": jax.random.normal(k_jl, x_gt.shape),
            "jitter_rec": jax.random.normal(k_jr, x_gt.shape)}.items()}
        got = corrupt_pose_from_draws(torch.from_numpy(x_gt), torch.from_numpy(a_mask),
                                      torch.from_numpy(is_lig), draws)
        assert got.shape == (1,) + x_gt.shape and not got.requires_grad
        assert np.abs(got.numpy() - ref).max() <= 1e-5, seed
        assert np.abs(ref - x_gt[None]).max() > 0.1  # it moved the pose
    # corrupt_pose draws from the generator, then does the same arithmetic
    args = [torch.from_numpy(a) for a in (x_gt, a_mask, is_lig)]
    draws = corrupt_pose_draws(torch.Generator().manual_seed(5), x_gt.shape[0])
    assert torch.equal(corrupt_pose(torch.Generator().manual_seed(5), *args),
                       corrupt_pose_from_draws(*args, draws))


def test_config_matches_jax_field_by_field():
    import dataclasses

    from physdock_tpu.config import ModelConfig as JaxModelConfig
    from physdock_tpu.config import model_presets as jax_presets
    from physdock_tpu_torch.config import ModelConfig, model_presets

    assert model_presets == jax_presets
    for name in model_presets:
        assert dataclasses.asdict(ModelConfig.preset(name)) == \
            dataclasses.asdict(JaxModelConfig.preset(name)), name
    ours, ref = PhysDockConfig.named("toy").loss, JaxConfig.named("toy").loss
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ModelConfig.preset("toy").no_blocks_heads == 2


def test_confidence_scores_match_jax_pipeline(jax_model, port_model, batch, poses):
    jm, jp = jax_model
    cfg = JaxConfig.named("toy")
    jpipe = JaxPipeline(cfg, jp, None, JaxSettings(enable_confidence=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        jcond = jm.apply(jp, jb, method="conditioning")
        ref, ref_scores = jpipe._confidence_scores(jb, jcond, poses, batch)
    pipe = DockingPipeline(PhysDockConfig.named("toy"), port_model, None,
                           SamplerSettings(enable_confidence=True), device="cpu")
    tb = _tb(batch)
    with torch.no_grad():
        got, scores = pipe._confidence_scores(tb, port_model.conditioning(tb), poses, batch)
    assert len(got) == len(ref) == len(poses)
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for k in ("ptm", "iptm", "ranking_confidence"):
            assert abs(g[k] - r[k]) <= 1e-4, (k, g[k], r[k])
        assert abs(g["mean_plddt"] - r["mean_plddt"]) <= 1e-2, (g["mean_plddt"], r["mean_plddt"])
        assert g["has_clash"] == r["has_clash"]
    np.testing.assert_allclose(scores, ref_scores, atol=1e-4, rtol=0)


def test_weight_bridge_with_the_head():
    flat = load_npz(NPZ)
    model = PhysDock(PhysDockConfig.named("toy").model, with_confidence=True)
    counts = load_jax_params(model, NPZ)
    assert counts == {"keys": len(flat), "unused_head_keys": 0, "unused_head_params": 0}
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in flat.values())
    back = state_dict_to_jax_flat(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)
    head = [k for k in flat if k.startswith("params/confidence_module/")]
    assert len(head) == HEAD_KEYS and sum(flat[k].size for k in head) == HEAD_PARAMS


def test_headless_model_loads_the_file_and_counts_the_head(tmp_path):
    flat = load_npz(NPZ)
    model = PhysDock(PhysDockConfig.named("toy").model)
    counts = load_jax_params(model, NPZ)
    assert counts == {"keys": len(flat) - HEAD_KEYS, "unused_head_keys": HEAD_KEYS,
                      "unused_head_params": HEAD_PARAMS}
    assert not any(n.startswith("confidence_module") for n in model.state_dict())
    # every other key stays strict: an unknown one raises, so does a
    # head key missing from a model with the head
    extra = dict(flat)
    extra["params/dit/unknown/weight"] = np.zeros((2, 2), np.float32)
    path = str(tmp_path / "extra.npz")
    np.savez(path, **extra)
    with pytest.raises(KeyError, match="weight bridge mismatch"):
        load_jax_params(PhysDock(PhysDockConfig.named("toy").model), path)
    short = {k: v for k, v in flat.items() if k != "params/confidence_module/linear_d/weight"}
    path = str(tmp_path / "short.npz")
    np.savez(path, **short)
    with pytest.raises(KeyError, match="weight bridge mismatch"):
        load_jax_params(PhysDock(PhysDockConfig.named("toy").model, with_confidence=True), path)
    # the same file's trunk loads into both models alike
    with_head = PhysDock(PhysDockConfig.named("toy").model, with_confidence=True)
    load_jax_params(with_head, NPZ)
    sd = with_head.state_dict()
    for n, t in model.state_dict().items():
        assert torch.equal(t, sd[n]), n


def test_state_dict_round_trips_through_jax_layout():
    sd = jax_flat_to_state_dict(load_npz(NPZ))
    model = PhysDock(PhysDockConfig.named("toy").model, with_confidence=True)
    assert set(sd) == set(model.state_dict())
    assert set(state_dict_to_jax_flat(sd)) == set(load_npz(NPZ))


def _cli_flags(out, extra=()):
    return ["-o", out, "--model_name", "toy", "--params", NPZ, "--steps", "2",
            "--max_rounds", "1", "--num_samples_per_round", "3", "--max_samples", "3",
            "--num_confs", "4", "--use_pocket", "--use_key_res", "--enable_physics_correction",
            "--enable_ranking", "--device", "cpu", *extra]


def _check_confidence(conf, n_poses):
    assert len(conf) == n_poses
    for m in conf:
        for k in ("mean_plddt", "ptm", "iptm", "ranking_confidence"):
            assert np.isfinite(m[k]), (k, m)
        assert 0.0 <= m["mean_plddt"] <= 100.0 and 0.0 <= m["ptm"] <= 1.0
        assert 0.0 <= m["iptm"] <= 1.0
    # ranked by the float32 scores, as in the JAX package
    scores = np.asarray([m["ranking_confidence"] for m in conf], np.float32)
    assert all(a >= b for a, b in zip(scores, scores[1:])), scores


def test_redocking_cli_with_confidence(tmp_path):
    from physdock_tpu_torch.cli import redocking

    demo = os.path.join(REPO, "demo", "redocking")
    out = str(tmp_path / "dock")
    (res,) = redocking.main([
        "-i", os.path.join(demo, "Posebusters_subset", "5SD5_HWI_A_1.pkl.gz"),
        "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", os.path.join(demo, "features", "msa_features"),
        "--uniprot_msa_features_dir", os.path.join(demo, "features", "uniprot_msa_features"),
        *_cli_flags(out, ["--enable_confidence", "--confidence_ranking"])])
    _check_confidence(res["confidence"], res["num_poses"])
    with open(os.path.join(out, "5SD5_HWI_A_1", "confidence.json")) as f:
        assert json.load(f) == res["confidence"]
    # ranked by ranking_confidence: the order is the argsort of the scores
    by_pose = {i: m for i, m in zip(res["rank_order"], res["confidence"])}
    scores = np.asarray([by_pose[i]["ranking_confidence"] for i in range(res["num_poses"])],
                        np.float32)
    assert res["rank_order"] == [int(i) for i in np.argsort(-scores)]


def test_screening_cli_with_confidence(tmp_path):
    from physdock_tpu_torch.cli import screening

    demo = os.path.join(REPO, "demo", "screening")
    with open(os.path.join(demo, "demo_db.txt")) as f:
        smiles = [ln.strip() for ln in f if ln.strip()][:2]
    smi = tmp_path / "lib.txt"
    smi.write_text("\n".join(smiles))
    common = ["-i", os.path.join(demo, "6kzd.pkl.gz"), "-s", str(smi),
              "--crop_size", "64", "--atom_crop_size", "512",
              "--msa_features_dir", os.path.join(demo, "features", "msa_features"),
              "--uniprot_msa_features_dir", os.path.join(demo, "features", "uniprot_msa_features")]
    out = str(tmp_path / "seq")
    res = screening.main(common + _cli_flags(out, ["--enable_confidence", "--vs_batch_size", "1"]))
    assert len(res) == 2
    md5 = json.load(open(os.path.join(out, "smiles_to_md5.json")))
    for r in res:
        assert "error" not in r
        conf = r["confidence"]
        assert len(conf) == r["num_poses"] and all(np.isfinite(m["ptm"]) for m in conf)
        assert os.path.exists(os.path.join(out, md5[r["smiles"]], "confidence.json"))
    # the batched screen scores no confidence, as the JAX package's
    out = str(tmp_path / "batched")
    res = screening.main(common + _cli_flags(out, ["--enable_confidence", "--vs_batch_size", "2"]))
    assert len(res) == 2 and all("confidence" not in r and "error" not in r for r in res)


def test_confidence_needs_the_head(tmp_path, batch, poses):
    from physdock_tpu_torch.cli import redocking

    pipe = DockingPipeline(PhysDockConfig.named("toy"), PhysDock(PhysDockConfig.named("toy").model),
                           None, SamplerSettings(enable_confidence=True), device="cpu")
    with pytest.raises(ValueError, match="with_confidence=True"):
        pipe._confidence_scores(_tb(batch), (None, None, None, None), poses, batch)
    with pytest.raises(ValueError, match="has no confidence head"):
        pipe.model.confidence(_tb(batch), None, None, torch.from_numpy(poses))
    for flag in ("--enable_confidence", "--confidence_ranking"):
        with pytest.raises(ValueError, match="needs params trained with it"):
            redocking.main(["-i", "unused.pkl.gz", "-o", str(tmp_path), "--model_name", "toy",
                            "--params", TOY_NPZ, "--device", "cpu", flag])


def test_train_cli_mini_rollout_cpu(tmp_path):
    """The train CLI with the mini-rollout at a toy size: the confidence
    losses logged, the head in the optimizer, the EMA and the checkpoint,
    and the EMA exported in the JAX layout, head included."""
    from physdock_tpu_torch.train import checkpoint as ckpt
    from physdock_tpu_torch.train import optim, train
    from physdock_tpu_torch.train.step import init_train_state

    data = tmp_path / "data" / "train_val"
    data.mkdir(parents=True)
    demo = os.path.join(REPO, "demo", "redocking", "Posebusters_subset", "5SD5_HWI_A_1.pkl.gz")
    os.symlink(demo, data / os.path.basename(demo))
    out = tmp_path / "ckpt"
    summary = train.main([
        "--dataset_dir", str(tmp_path / "data"), "-o", str(out), "--model_name", "toy",
        "--crop_size", "32", "--atom_crop_size", "256", "--num_augmentation_sample", "2",
        "--total_steps", "2", "--save_every", "2", "--seed", "1", "--device", "cpu",
        "--use_mini_rollout", "--mini_rollout_steps", "2", "--alpha_pae", "1.0"])
    assert summary["steps"] == [1, 2]
    for logs in summary["logs"]:
        assert {"plddt_loss", "pae_loss", "pde_loss"} <= set(logs)
        assert all(np.isfinite(v) for v in logs.values()), logs
    state = summary["state"]
    head = [n for n in state.params if n.startswith("confidence_module.")]
    assert head and all(n in state.opt_state.mu and n in state.ema_params for n in head)
    assert any(float(state.opt_state.mu[n].abs().max()) > 0 for n in head)
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    fresh = PhysDock(cfg.model, with_confidence=True)
    restored = ckpt.restore_train_state(str(out / "step_00000002.pt"),
                                        init_train_state(fresh, optim.make_optimizer()))
    for n in head:
        assert torch.equal(restored.ema_params[n], state.ema_params[n]), n
    path = str(tmp_path / "ema.npz")
    ckpt.save_params_npz(path, state.ema_params)
    counts = load_jax_params(PhysDock(cfg.model, with_confidence=True), path)
    assert counts["keys"] == len(load_npz(path)) and counts["unused_head_keys"] == 0
    assert len([k for k in load_npz(path) if "/confidence_module/" in k]) == HEAD_KEYS


def test_mini_rollout_step_batch2_matches_jax_step():
    """The corrupt-pose route with every confidence loss weighted 1 (the
    release alpha_pae is 0, which would leave the PAE head untrained), on
    two systems with padded tokens."""
    singles = [make_synthetic_batch(n_tokens=12, n_atoms=40, n_msa=4, n_ligand_tokens=5,
                                    seed=s, pad_tokens=4, pad_atoms=8) for s in (0, 1)]
    jlogs, logs, changes = step_parity(NPZ, singles, with_confidence=True,
                                       loss_overrides=dict(alpha_pae=1.0, alpha_confidence=1.0))
    assert {"plddt_loss", "pae_loss", "pde_loss"} <= set(logs)
    check_step_parity(jlogs, logs, changes)
    ref, got = changes["params"]
    for n, r in ref.items():
        if n.startswith("confidence_module."):
            assert float(r.abs().max()) > 0 and float(got[n].abs().max()) > 0, n
