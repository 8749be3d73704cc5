"""Lockstep of the PyTorch port's EDM sampler with the JAX package's.

Both samplers run the toy model (`_overfit/ema_params.npz`) on a small
synthetic batch for 4 steps with physics guidance on (conformer-bank
matching at high sigma, restraint-field relaxation at low sigma) and the
same caller-given noise (`noise_override`).  The coordinates after every
step agree within 1e-2 A (fp32 on the CPU; the first steps sit at
sigma ~ 2560 A, so 1e-2 A is ~4e-6 relative there).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model import diffusion as jdiff
from physdock_tpu.model import forcefield as jff
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model import diffusion as tdiff
from physdock_tpu_torch.model import forcefield as tff
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "_overfit", "ema_params.npz")
STEPS, S, K = 4, 2, 3
ATOL = 1e-2  # Angstrom


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _setup():
    batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=4)
    atom_tok = np.asarray(batch["atom_id_to_token_id"])
    lig_idx = np.nonzero((np.asarray(batch["is_ligand"])[atom_tok] > 0)
                         & (np.asarray(batch["a_mask"]) > 0))[0]
    L = len(lig_idx)
    rng = np.random.default_rng(21)
    ref = (np.asarray(batch["x_gt"])[lig_idx]).astype(np.float32)
    ff_args = dict(
        atomic_numbers=[6, 6, 7, 6, 8, 6][:L],
        bonds=[(i, i + 1) for i in range(L - 1)],
        ref_pos=ref,
        chiral_centers=[(1, (0, 2, 3, 4))],
    )
    conf = (ref[None] + rng.normal(size=(K, L, 3)) * 0.5).astype(np.float32)
    conf_d = np.linalg.norm(conf[:, :, None] - conf[:, None], axis=-1).astype(np.float32)
    conf_m = np.array([1, 1, 0], np.float32)
    A = np.asarray(batch["ref_pos"]).shape[0]
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(STEPS * S)])
    noise = dict(
        x_init_z=rng.normal(size=(S, A, 3)).astype(np.float32),
        aug_R=rot.reshape(STEPS, S, 3, 3).astype(np.float32),
        aug_t=rng.normal(size=(STEPS, S, 3)).astype(np.float32),
        churn_z=rng.normal(size=(STEPS, S, A, 3)).astype(np.float32),
    )
    return batch, lig_idx, ff_args, (conf, conf_d, conf_m), noise


def test_sampler_lockstep_with_guidance():
    batch, lig_idx, ff_args, (conf, conf_d, conf_m), noise = _setup()
    L = len(lig_idx)
    kw = dict(num_sample=S, steps=STEPS, karras_rho=7.0, mmff_gamma_0_factor=20.0,
              mmff_iters=5, align_ref_pos=True, return_trajectory=True)
    sig = jdiff.karras_noise_schedule(STEPS, 16.0, 160.0, 4e-3, 7.0)
    assert (sig[:-1] > 20.0).any() and (sig[:-1] <= 20.0).any()  # both guidance branches

    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    jparams = load_params_npz(NPZ)
    jg = jdiff.PhysicsGuidance(
        ligand_idx=jnp.asarray(lig_idx, jnp.int32), ligand_mask=jnp.ones(L),
        conf_pos=jnp.asarray(conf), conf_dists=jnp.asarray(conf_d), conf_mask=jnp.asarray(conf_m),
        ff=jff.build_ligand_ff(**ff_args))
    jtraj = jdiff.sample_diffusion(
        jm, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
        guidance=jg, noise_override={k: jnp.asarray(v) for k, v in noise.items()}, **kw)

    tm = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(tm, NPZ)
    tg = tdiff.PhysicsGuidance(
        ligand_idx=torch.as_tensor(lig_idx), ligand_mask=torch.ones(L),
        conf_pos=torch.from_numpy(conf), conf_dists=torch.from_numpy(conf_d),
        conf_mask=torch.from_numpy(conf_m), ff=tff.build_ligand_ff(**ff_args))
    ttraj = tdiff.sample_diffusion(
        tm.eval(), {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        guidance=tg, noise_override={k: torch.from_numpy(v) for k, v in noise.items()}, **kw)

    jtraj, ttraj = np.asarray(jtraj), ttraj.numpy()
    assert jtraj.shape == ttraj.shape == (STEPS, S, 48, 3)
    assert np.all(np.isfinite(ttraj))
    for i in range(STEPS):
        err = np.abs(jtraj[i] - ttraj[i]).max()
        assert err <= ATOL, f"step {i}: max abs err {err} A"


def test_karras_schedule_matches_jax():
    for steps, rho in ((1, 7.0), (40, 1000.0), (12, 7.0)):
        np.testing.assert_array_equal(jdiff.karras_noise_schedule(steps, 16.0, 160.0, 4e-3, rho),
                                      tdiff.karras_noise_schedule(steps, 16.0, 160.0, 4e-3, rho))
