"""The PyTorch port's model in bf16 (`--bf16`: fp32 parameters, bf16
compute, the DiT bias stored in bf16) against the JAX package in bf16,
with the committed toy weights (`_overfit/ema_params.npz`) on the CPU.

Tolerances:
  * `conditioning` (a, ap, s, z): max abs error <= 2e-2 * max|ref|, the
    kernels' bf16 limit, read against the JAX bf16 output;
  * `denoise` coordinates: max and mean abs error within the fp32-vs-bf16
    drift recorded for the JAX package in `BF16_DRIFT.json`
    (`coord_abs_delta_max_A`, `coord_abs_delta_mean_A`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "_overfit", "ema_params.npz")
REL_BF16 = 2e-2
with open(os.path.join(ROOT, "BF16_DRIFT.json")) as f:
    _DRIFT = json.load(f)


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def outputs():
    batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=3)
    rng = np.random.default_rng(5)
    x_hat = (rng.normal(size=(3, 48, 3)) * 12).astype(np.float32)
    t_hat = np.array([0.5, 16.0, 160.0], np.float32)

    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model, dtype=jnp.bfloat16)
    jparams = load_params_npz(NPZ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        ja = jm.apply(jparams, jb, method="conditioning")
        jd = jm.apply(jparams, jb, jnp.asarray(x_hat), jnp.asarray(t_hat), *ja, method="denoise")

    tm = PhysDock(PhysDockConfig.named("toy").model, dtype=torch.bfloat16)
    load_jax_params(tm, NPZ)
    tm.eval()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        ta = tm.conditioning(tb)
        td = tm.denoise(tb, torch.from_numpy(x_hat), torch.from_numpy(t_hat), *ta)
    ref = [np.asarray(x, np.float32) for x in (*ja, jd)]
    out = [x.float().numpy() for x in (*ta, td)]
    return ref, out


@pytest.mark.parametrize("i,name", list(enumerate(("a", "ap", "s", "z"))))
def test_conditioning_bf16_matches_jax(outputs, i, name):
    ref, out = outputs[0][i], outputs[1][i]
    assert ref.shape == out.shape and np.isfinite(out).all()
    err = np.abs(ref - out).max()
    assert err <= REL_BF16 * np.abs(ref).max(), f"{name}: max abs err {err}"


def test_denoise_bf16_matches_jax(outputs):
    ref, out = outputs[0][4], outputs[1][4]
    assert ref.shape == out.shape and np.isfinite(out).all()
    delta = np.abs(ref - out)
    assert delta.max() <= _DRIFT["coord_abs_delta_max_A"], f"max {delta.max()} A"
    assert delta.mean() <= _DRIFT["coord_abs_delta_mean_A"], f"mean {delta.mean()} A"
