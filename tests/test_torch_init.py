"""The PyTorch port's random initialization against the JAX package's, for
the toy preset: a model trained from random weights (the train-to-dock
gate, `scripts/torch_overfit_gate.py`) must start from the distribution
the JAX gate starts from.

The port's `PhysDock(cfg, generator=...)` and the JAX `model.init` (on a
small synthetic batch) must give the same parameter keys and shapes
(through the port's weight bridge), the same tensors zero or constant
with the same constant, and, for every other tensor of at least 1024
elements, the same standard deviation within five standard errors of a
sample std (rel 5 / sqrt(2 n)): the two draw different numbers from the
same distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict


def _constant(t: torch.Tensor):
    """The value of a tensor whose entries are all equal, else None."""
    flat = t.reshape(-1)
    return float(flat[0]) if bool((flat == flat[0]).all()) else None


def test_random_init_matches_jax_init():
    batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6)
    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
    flat = {"params/" + k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}
    ref = jax_flat_to_state_dict(flat)
    got = PhysDock(PhysDockConfig.named("toy").model,
                   generator=torch.Generator().manual_seed(0)).state_dict()

    assert set(got) == set(ref), (sorted(set(got) ^ set(ref)))[:10]
    assert len(ref) > 500
    compared = 0
    for name, r in ref.items():
        g = got[name].float()
        assert g.shape == r.shape, (name, g.shape, r.shape)
        cr, cg = _constant(r), _constant(g)
        assert (cr is None) == (cg is None), (name, cr, cg)
        if cr is not None:
            assert cg == cr, (name, cg, cr)
        elif r.numel() >= 1024:
            n = r.numel()
            sr, sg = float(r.double().std()), float(g.double().std())
            assert abs(sg - sr) <= 5.0 / np.sqrt(2 * n) * sr, (name, n, sg, sr)
            compared += 1
    assert compared > 100
