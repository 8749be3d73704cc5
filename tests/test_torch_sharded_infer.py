"""The PyTorch port's dp-sharded sampler (`infer/sharded.py`) on the CPU,
over 2 and 4 gloo ranks (`parallel/launch.run_ranks`).

The toy model (`_overfit/ema_params.npz`) samples 8 poses of a small
synthetic system for 4 steps. Sharded over dp (4 and 2 poses a rank),
every rank returns all 8 poses, and they equal the unsharded sampler's
within 1e-5 A, once with the noise drawn from a generator of one seed
(each pose gets exactly the draws it gets unsharded) and once with
caller-given noise. With that noise, the poses also equal the JAX
`sharded_sample_diffusion` on a dp=2 mesh of the virtual CPU devices
within 1e-2 A, the limit of the sampler's lockstep against JAX
(tests/test_torch_sampler.py: the first steps sit at sigma ~ 2560 A).

A rank of one pose runs the model's matmuls at batch 1, which CPU BLAS
rounds differently from a larger batch: 3.1e-4 A at these 4 steps'
~380 A coordinates (8e-7 relative). That the draws of a pose do not
depend on the split is held exactly, one pose a slice, with a denoiser
whose arithmetic is per element (`test_sample_range_slices_the_draws`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.infer.sharded import sharded_sample_diffusion as jax_sharded
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.parallel.mesh import make_mesh
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.diffusion import sample_diffusion
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.parallel.launch import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
NUM_SAMPLE, STEPS, SEED = 8, 4, 5
ATOL_SHARDED, ATOL_JAX = 1e-5, 1e-2  # Angstrom


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=4)
    A = np.asarray(batch["ref_pos"]).shape[0]
    rng = np.random.default_rng(9)
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(STEPS * NUM_SAMPLE)])
    noise = dict(
        x_init_z=rng.normal(size=(NUM_SAMPLE, A, 3)).astype(np.float32),
        aug_R=rot.reshape(STEPS, NUM_SAMPLE, 3, 3).astype(np.float32),
        aug_t=rng.normal(size=(STEPS, NUM_SAMPLE, 3)).astype(np.float32),
        churn_z=rng.normal(size=(STEPS, NUM_SAMPLE, A, 3)).astype(np.float32),
    )
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tnoise = {k: torch.from_numpy(v) for k, v in noise.items()}
    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, NPZ)
    model.eval()
    kw = dict(num_sample=NUM_SAMPLE, steps=STEPS)
    ref = {"drawn": sample_diffusion(model, tbatch, generator=torch.Generator().manual_seed(SEED),
                                     **kw),
           "given": sample_diffusion(model, tbatch, noise_override=tnoise, **kw)}
    tmp = tmp_path_factory.mktemp("sharded")
    path = os.path.join(tmp, "blob.pt")
    torch.save(dict(npz=NPZ, batch=tbatch, noise=tnoise, seed=SEED, **kw), path)
    return batch, noise, ref, path, tmp


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_sampler_equals_unsharded(setup, dp):
    _, _, ref, path, tmp = setup
    ranks = run_ranks(torch_ranks.sharded_sample, dp, args=(path,), rdv_dir=str(tmp / f"rdv{dp}"))
    for r in ranks:
        for k in ("drawn", "given"):
            assert r[k].shape == ref[k].shape == (NUM_SAMPLE, 48, 3)
            assert torch.isfinite(r[k]).all()
            err = float((r[k] - ref[k]).abs().max())
            assert err <= ATOL_SHARDED, (dp, k, err)
    # the draws differ per pose: the poses are not one pose repeated
    assert float((ref["drawn"][0] - ref["drawn"][1]).abs().max()) > 1e-3


class _ElementwiseDenoiser:
    """A denoiser whose output at a pose depends on that pose alone, with
    no reduction: the sampler's result is then a function of the draws."""

    cfg = PhysDockConfig.named("toy").model

    def conditioning(self, batch):
        return tuple(torch.zeros(1) for _ in range(4))

    def denoise_bias_cache(self, batch, ap, z):
        return None

    def denoise(self, batch, x_hat, t_hat, *rest):
        return x_hat * 0.5 + torch.tanh(t_hat)[..., None, None]


def test_sample_range_slices_the_draws(setup):
    _, _, _, path, _ = setup
    batch = torch.load(path, weights_only=False)["batch"]
    model = _ElementwiseDenoiser()
    kw = dict(num_sample=NUM_SAMPLE, steps=STEPS)
    full = sample_diffusion(model, batch, generator=torch.Generator().manual_seed(SEED), **kw)
    parts = [sample_diffusion(model, batch, generator=torch.Generator().manual_seed(SEED),
                              sample_range=(i, i + 1), **kw) for i in range(NUM_SAMPLE)]
    assert torch.equal(torch.cat(parts), full)


def test_sharded_sampler_matches_jax_sharded(setup):
    batch, noise, ref, _, _ = setup
    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    with jax.default_matmul_precision("highest"):
        x = jax_sharded(jm, load_params_npz(NPZ), {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0), make_mesh(dp=2, devices=jax.devices()[:2]),
                        num_sample=NUM_SAMPLE, steps=STEPS,
                        noise_override={k: jnp.asarray(v) for k, v in noise.items()})
    err = float(np.abs(np.asarray(x) - ref["given"].numpy()).max())
    assert err <= ATOL_JAX, err
