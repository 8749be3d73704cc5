"""The JAX gate's draws reproduced without JAX (`scripts/torch_jax_draws.py`)
against `jax.random` and the JAX `augmentation_diffuse` on the CPU.

Tolerances: keys, raw bits and float32 uniforms equal `jax.random`'s bit
for bit. Normals (and so t_hat, the noise and the translation) agree
within rel 1e-5 elementwise: the module runs XLA's float32 `erf_inv`
polynomial, but its `log1p` is NumPy's, which differs from XLA's in the
last bit on a few percent of draws (measured: max rel 2.4e-7 over 200k
draws; torch's `erfinv` would give 5.4e-6). Rotations (XLA's and NumPy's
cos, sin and arccos) and the centred x_hat within 1e-5 of max |x_hat|.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.utils.geometry import uniform_random_rotation as jax_rotation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_jax_draws as D  # noqa: E402


def _raw(key):
    return np.asarray(jax.random.key_data(key)) if jnp.issubdtype(key.dtype, jax.dtypes.prng_key) \
        else np.asarray(key)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5])
def test_keys_bits_and_uniforms_are_jax_bit_for_bit(seed):
    jk = jax.random.PRNGKey(seed)
    nk = D.prng_key(seed)
    assert (_raw(jk) == nk).all()
    for data in (0, 3, 5999, 2**32 - 1):
        assert (_raw(jax.random.fold_in(jk, data)) == D.fold_in(nk, data)).all()
    for num in (2, 3, 5):
        assert (_raw(jax.random.split(jk, num)) == D.split(nk, num)).all()
    assert (np.asarray(jax.random.bits(jk, (3, 5, 7), jnp.uint32)) == D.random_bits(nk, (3, 5, 7))).all()
    assert (np.asarray(jax.random.uniform(jk, (4097,))) == D.uniform(nk, (4097,))).all()
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    assert (np.asarray(jax.random.uniform(jk, (4097,), jnp.float32, lo, 1.0))
            == D.uniform(nk, (4097,), lo, 1.0)).all()


def test_normals_and_rotations_match_jax():
    rng = np.random.default_rng(0)
    for data in rng.integers(0, 2**31, size=4):
        jk = jax.random.fold_in(jax.random.PRNGKey(11), int(data))
        nk = D.fold_in(D.prng_key(11), int(data))
        jn = np.asarray(jax.random.normal(jk, (20000,)))
        nn = D.normal(nk, (20000,))
        np.testing.assert_allclose(nn, jn, rtol=1e-5, atol=0)
        jr = np.asarray(jax_rotation(jk, (8,)))
        np.testing.assert_allclose(D.uniform_random_rotation(nk, (8,)), jr, rtol=0, atol=1e-5)


def test_three_gate_steps_draw_what_the_jax_step_draws():
    """The gate's key stream (seed 0, a window resumed at step 4, groups
    of 1 and 3 systems in turn) at the CPU smoke's size: 2 augmentation
    samples of 512 atoms. The JAX side is `augmentation_diffuse` under the
    keys `scripts/overfit_gate.py` and the train step derive."""
    n_aug, n_atoms, seed, start = 2, 512, 0, 4
    jcfg = JaxConfig.named("toy", num_augmentation_sample=n_aug)
    jm = JaxPhysDock(cfg=jcfg.model)
    rng = np.random.default_rng(3)
    systems = []
    for _ in range(4):
        x_exists = (rng.random(n_atoms) < 0.8).astype(np.float32)
        systems.append({"x_gt": (rng.normal(size=(n_atoms, 3)) * 10).astype(np.float32),
                        "x_exists": x_exists})
    groups = [[0], [1, 2, 3]]

    diffuse = jax.jit(lambda micro, key: jm.apply({"params": {}}, micro, key,
                                                  method="augmentation_diffuse"))
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), start)
    keys = D.GateKeys(seed, start)
    for step_i in range(start, start + 3):
        jkey, jk_step = jax.random.split(jkey)
        k_step = keys.next_step()
        assert (_raw(jk_step) == k_step).all()
        for i, s in enumerate(groups[step_i % 2]):
            micro = {k: jnp.asarray(v) for k, v in systems[s].items()}
            jx, jt = diffuse(micro, jax.random.fold_in(jk_step, i))
            d = D.system_draws(keys.system_key(k_step, i), torch.from_numpy(systems[s]["x_gt"]),
                               torch.from_numpy(systems[s]["x_exists"]), n_aug,
                               jcfg.model.sigma_data)
            jx, jt = np.asarray(jx), np.asarray(jt)
            assert d["x_hat"].shape == jx.shape and d["t_hat"].shape == jt.shape
            np.testing.assert_allclose(d["t_hat"].numpy(), jt, rtol=1e-5, atol=0)
            np.testing.assert_allclose(d["x_hat"].numpy(), jx, rtol=0,
                                       atol=1e-5 * np.abs(jx).max())
