"""The mini-rollout's rollout route of the port's train step against the
JAX package's mini-rollout step on the same key, on the CPU.

The JAX step splits each system's key into `k_fwd` and `k_roll`; the
rollout (`sample_diffusion`, one sample, no guidance) gives its sample
the stream `fold_in(k_roll, 0)` and splits it once per step.
`scripts/torch_jax_draws.py::system_draws` computes those draws without
JAX, in the port's `noise_override` layout, and the port's step takes
them through `draws=`.

  * the rollout's and the corrupted pose's draws against `jax.random`
    under the same keys: rotations within 1e-5, normals within rel 1e-5
    (the tolerances of tests/test_torch_jax_draws.py), the uniform bit
    for bit;
  * one step of the toy model with the committed confidence weights on
    two systems with padded tokens, 2 rollout steps, every confidence loss
    weighted 1: the loss terms within rel 1e-4 and the change of params,
    Adam moments and EMA within rel 1e-3 of their norms (nu 2e-3), by
    `test_torch_train.check_step_parity`, as the plain and corrupt-pose
    steps are held.
"""

import os
import sys

import jax
import numpy as np
import pytest
from test_torch_train import check_step_parity, step_parity

from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.utils.geometry import uniform_random_rotation as jax_rotation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_jax_draws as D  # noqa: E402

NPZ = os.path.join(REPO, "_confidence", "ema_params_conf.npz")


def test_rollout_and_corrupt_draws_match_jax_keys():
    n_atoms, steps = 40, 3
    k_roll = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 1))[1]
    nk = D.split(D.fold_in(D.prng_key(7), 1))[1]
    assert (np.asarray(jax.random.key_data(k_roll)) == nk).all()

    got = D.rollout_draws(nk, n_atoms, steps)
    stream = jax.random.fold_in(k_roll, 0)
    want = {"x_init_z": [jax.random.normal(jax.random.fold_in(stream, 0), (n_atoms, 3))],
            "aug_R": [], "aug_t": [], "churn_z": []}
    for _ in range(steps):
        stream, k_aug, k_churn = jax.random.split(stream, 3)
        kr, kt = jax.random.split(k_aug)
        want["aug_R"].append(jax_rotation(kr, ()))
        want["aug_t"].append(jax.random.normal(kt, (3,)))
        want["churn_z"].append(jax.random.normal(k_churn, (n_atoms, 3)))
    shapes = {"x_init_z": (1, n_atoms, 3), "aug_R": (steps, 1, 3, 3), "aug_t": (steps, 1, 3),
              "churn_z": (steps, 1, n_atoms, 3)}
    for k, shape in shapes.items():
        w = np.stack([np.asarray(x) for x in want[k]])
        assert got[k].shape == shape, (k, got[k].shape)
        if k == "aug_R":
            np.testing.assert_allclose(got[k].reshape(w.shape), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got[k].reshape(w.shape), w, rtol=1e-5, atol=0)

    c = D.corrupt_draws(nk, n_atoms)
    k_m, k_dir, k_rot, k_jl, k_jr = jax.random.split(k_roll, 5)
    assert c["u"] == np.asarray(jax.random.uniform(k_m))
    np.testing.assert_allclose(c["direction"], jax.random.normal(k_dir, (3,)), rtol=1e-5)
    np.testing.assert_allclose(c["rot"], jax_rotation(k_rot, ()), atol=1e-5)
    np.testing.assert_allclose(c["jitter_lig"], jax.random.normal(k_jl, (n_atoms, 3)), rtol=1e-5)
    np.testing.assert_allclose(c["jitter_rec"], jax.random.normal(k_jr, (n_atoms, 3)), rtol=1e-5)


@pytest.mark.parametrize("rollout_steps", [2])
def test_mini_rollout_step_rollout_route_matches_jax_step(rollout_steps):
    singles = [make_synthetic_batch(n_tokens=12, n_atoms=40, n_msa=4, n_ligand_tokens=5,
                                    seed=s, pad_tokens=4, pad_atoms=8) for s in (0, 1)]
    jlogs, logs, changes = step_parity(NPZ, singles, with_confidence=True,
                                       loss_overrides=dict(alpha_pae=1.0, alpha_confidence=1.0),
                                       rollout_steps=rollout_steps)
    assert {"plddt_loss", "pae_loss", "pde_loss"} <= set(logs)
    check_step_parity(jlogs, logs, changes)
