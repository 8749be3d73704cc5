"""Trunk recycling (`num_recycles` > 0) of the PyTorch port against the
JAX package, with the committed toy weights (`_overfit/ema_params.npz`)
on conftest's `tiny_batch` (16 tokens, 48 atoms), fp32 on the CPU.

The recycle projections are zero-initialised, so at init a wrong loop
gives the same (s, z) as no loop at all. Here the four recycle tensors
(`recycle_norm_{s,z}.weight`, `recycle_linear_{s,z}.weight`) are set from
a numpy seed to non-zero values, written with the toy weights to one JAX
`.npz` artifact through the weight bridge, and read back by both
packages' own loaders.

Limits: s and z within rel 1e-3 of max|JAX| at 1 and 2 recycles, as in
tests/test_torch_model.py (and at 1 recycle s must differ from the
0-recycle trunk's by more than 10x that); the gradients of a fixed random
projection of (s, z) at one recycle within rel 1e-3 (REL_GRAD of
tests/test_torch_train.py) by tensor norm, for the recycle projections
(whose gradient comes through the last pass only) and for the MSA
embedding (whose gradient comes through every pass); the recycle tensors
round-trip the bridge bit for bit.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz as jax_load_npz
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict, load_jax_params
from physdock_tpu_torch.train.checkpoint import load_params_npz, save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
REL_OUT, REL_GRAD = 1e-3, 1e-3
TE = "diffusion_conditioning.token_embedder."
RECYCLE = [TE + n for n in ("recycle_norm_s.weight", "recycle_linear_s.weight",
                            "recycle_norm_z.weight", "recycle_linear_z.weight")]
GRAD_NAMES = [TE + "recycle_linear_s.weight", TE + "recycle_linear_z.weight",
              TE + "linear_msa_feat.weight"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _model(n):
    cfg = PhysDockConfig.named("toy")
    return PhysDock(dataclasses.replace(cfg.model, num_recycles=n))


@pytest.fixture(scope="module")
def recycle_npz(tmp_path_factory):
    """The toy weights plus non-zero recycle tensors from a numpy seed, as
    one JAX `.npz` artifact (fp32); returns its path and the port
    state_dict it was written from."""
    model = _model(1)
    sd = {n: t.clone() for n, t in model.state_dict().items()}
    sd.update({n: t for n, t in load_params_npz(NPZ).items()})
    rng = np.random.default_rng(21)
    for n in RECYCLE:
        shape = tuple(sd[n].shape)
        a = 1.0 + 0.2 * rng.normal(size=shape) if "norm" in n else 0.05 * rng.normal(size=shape)
        sd[n] = torch.from_numpy(a.astype(np.float32))
    root = tmp_path_factory.mktemp("recycle")
    path = str(root / "recycle.npz")
    save_params_npz(path, sd, dtype=None)
    yield path, sd
    shutil.rmtree(root, ignore_errors=True)


def test_recycle_tensors_round_trip_the_bridge(recycle_npz):
    path, sd = recycle_npz
    back = load_params_npz(path)
    assert set(back) == set(sd)
    for n in RECYCLE:
        assert torch.equal(back[n], sd[n]), n
    flat = {"params/" + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax_load_npz(path)["params"]).items()}
    from_jax = jax_flat_to_state_dict(flat)
    for n in RECYCLE:
        assert torch.equal(from_jax[n], sd[n]), n
    model = _model(1)
    load_jax_params(model, path)  # every key used exactly once
    for n in RECYCLE:
        assert float(model.state_dict()[n].abs().max()) > 0, n


def _objective_weights(n_tokens, c_s, c_z):
    rng = np.random.default_rng(4)
    return (rng.normal(size=(n_tokens, c_s)).astype(np.float32),
            rng.normal(size=(n_tokens, n_tokens, c_z)).astype(np.float32))


def _jax_trunk(path, batch, n, with_grad=False):
    """JAX (s, z) at `n` recycles and, `with_grad`, in the same compile the
    gradient of sum(s * ws) + sum(z * wz) (`_objective_weights`)."""
    cfg = JaxConfig.named("toy").model
    jm = JaxPhysDock(cfg=dataclasses.replace(cfg, num_recycles=n))
    params = jax_load_npz(path)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ws, wz = _objective_weights(batch["s_mask"].shape[0], cfg.c_s, cfg.c_z)

    def run(p):
        def trunk(q):
            return jm.apply(q, jb, method="conditioning")[2:]

        if not with_grad:
            return trunk(p), None
        (s, z), back = jax.vjp(trunk, p)
        return (s, z), back((jnp.asarray(ws), jnp.asarray(wz)))[0]

    with jax.default_matmul_precision("highest"):
        (s, z), grads = jax.jit(run)(params)
    if grads is not None:
        grads = jax_flat_to_state_dict({"/".join(k): np.asarray(v)
                                        for k, v in flatten_dict(grads).items()})
    return np.asarray(s), np.asarray(z), grads


@pytest.fixture(scope="module")
def jax_one_recycle(recycle_npz, tiny_batch):
    return _jax_trunk(recycle_npz[0], tiny_batch, 1, with_grad=True)


def _port_trunk(path, batch, n):
    model = _model(n)
    load_jax_params(model, path)
    with torch.no_grad():
        _, _, s, z = model.conditioning({k: torch.from_numpy(np.asarray(v))
                                         for k, v in batch.items()})
    return s.numpy(), z.numpy()


@pytest.mark.parametrize("n", [1, 2])
def test_recycled_trunk_matches_jax(recycle_npz, tiny_batch, jax_one_recycle, n):
    path, _ = recycle_npz
    ref = jax_one_recycle[:2] if n == 1 else _jax_trunk(path, tiny_batch, n)[:2]
    got = _port_trunk(path, tiny_batch, n)
    for name, r, g in zip(("s", "z"), ref, got):
        assert r.shape == g.shape and np.isfinite(g).all(), name
        err = np.abs(r - g).max()
        assert err <= REL_OUT * np.abs(r).max(), (n, name, err, np.abs(r).max())
    if n == 1:  # the non-zero projections change the trunk's output
        model = _model(0)
        model.load_state_dict({k: v for k, v in load_params_npz(path).items()
                               if "recycle_" not in k})
        with torch.no_grad():
            s0 = model.conditioning({k: torch.from_numpy(np.asarray(v))
                                     for k, v in tiny_batch.items()})[2].numpy()
        assert np.abs(s0 - got[0]).max() > 10 * REL_OUT * np.abs(ref[0]).max()


def test_gradient_through_one_recycle_matches_jax(recycle_npz, tiny_batch, jax_one_recycle):
    path, _ = recycle_npz
    ref = jax_one_recycle[2]
    model = _model(1)
    load_jax_params(model, path)
    _, _, s, z = model.conditioning({k: torch.from_numpy(np.asarray(v))
                                     for k, v in tiny_batch.items()})
    ws, wz = _objective_weights(s.shape[0], s.shape[-1], z.shape[-1])
    loss = (s * torch.from_numpy(ws)).sum() + (z * torch.from_numpy(wz)).sum()
    named = dict(model.named_parameters())
    got = torch.autograd.grad(loss, [named[n] for n in GRAD_NAMES])
    for name, g in zip(GRAD_NAMES, got):
        r = ref[name].numpy()
        nr = np.linalg.norm(r)
        assert nr > 0, name
        rel = np.linalg.norm(g.numpy() - r) / nr
        assert rel <= REL_GRAD, (name, rel)
