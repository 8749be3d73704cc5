"""The PyTorch port's model against the JAX package with the committed toy
weights (`_overfit/ema_params.npz`, full widths, 23.4 M parameters).

  * the weight bridge: npz -> state_dict -> npz gives the same flat dict,
    and every key is used exactly once; the state_dict also converts back
    through the JAX package's reference-checkpoint importer
    (`model/import_weights.py::convert_state_dict`) to the same flax tree;
  * `conditioning` (a, ap, s, z) and `denoise` on a small synthetic batch,
    within rel 1e-3 of max|ref| (fp32 on the CPU);
  * the compact int8 transport expands to the same fat features.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model import compact as jcompact
from physdock_tpu.model.import_weights import convert_state_dict, tree_paths
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model import compact as tcompact
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import (
    jax_flat_to_state_dict,
    load_jax_params,
    load_npz,
    state_dict_to_jax_flat,
)

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "_overfit", "ema_params.npz")
REL = 1e-3


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def models():
    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    jparams = load_params_npz(NPZ)
    tm = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(tm, NPZ)
    return jm, jparams, tm.eval()


@pytest.fixture(scope="module")
def batch():
    return make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=3)


def _rel_close(ref, out, rel=REL):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape
    err = np.abs(ref - out).max()
    assert err <= rel * np.abs(ref).max(), f"max abs err {err} vs max|ref| {np.abs(ref).max()}"


def test_weight_round_trip():
    flat = load_npz(NPZ)
    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, NPZ)
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in flat.values())
    back = state_dict_to_jax_flat(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


def test_state_dict_converts_back_through_convert_state_dict():
    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, NPZ)
    tree = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    ref = load_params_npz(NPZ)
    paths = set(tree_paths(ref))
    assert set(tree_paths(tree)) == paths

    def leaf(t, path):
        for k in path:
            t = t[k]
        return np.asarray(t)

    for path in paths:
        np.testing.assert_array_equal(leaf(tree, path), leaf(ref, path).astype(np.float32),
                                      err_msg="/".join(path))


def test_weight_bridge_rejects_unused_and_missing_keys():
    flat = load_npz(NPZ)
    model = PhysDock(PhysDockConfig.named("toy").model)
    sd = jax_flat_to_state_dict(flat)
    assert set(sd) == set(model.state_dict())
    extra = dict(flat)
    extra["params/dit/unknown/weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="weight bridge mismatch"):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "p.npz")
            np.savez(path, **extra)
            load_jax_params(model, path)


def test_conditioning_and_denoise_match_jax(models, batch):
    jm, jparams, tm = models
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    ja = jm.apply(jparams, jb, method="conditioning")
    with torch.no_grad():
        ta = tm.conditioning(tb)
    for name, r, o in zip(("a", "ap", "s", "z"), ja, ta):
        _rel_close(r, o.numpy())

    rng = np.random.default_rng(5)
    x_hat = (rng.normal(size=(3, 48, 3)) * 12).astype(np.float32)
    t_hat = np.array([0.5, 16.0, 160.0], np.float32)
    jd = jm.apply(jparams, jb, jnp.asarray(x_hat), jnp.asarray(t_hat), *ja, method="denoise")
    with torch.no_grad():
        td = tm.denoise(tb, torch.from_numpy(x_hat), torch.from_numpy(t_hat), *ta)
    _rel_close(jd, td.numpy())


def test_expand_batch_matches_jax(batch):
    feats = {k: np.asarray(v) for k, v in batch.items()}
    compact = jcompact.compact_batch_np(feats)
    tcompact_np = tcompact.compact_batch_np(feats)
    assert set(compact) == set(tcompact_np)
    for k in compact:
        np.testing.assert_array_equal(compact[k], tcompact_np[k], err_msg=k)
    je = jcompact.expand_batch({k: jnp.asarray(v) for k, v in compact.items()})
    te = tcompact.expand_batch({k: torch.from_numpy(v) for k, v in compact.items()})
    for k in tcompact.FAT_KEYS:
        np.testing.assert_array_equal(np.asarray(je[k]), te[k].numpy(), err_msg=k)
