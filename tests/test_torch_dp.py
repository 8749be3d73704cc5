"""Data-parallel training of the PyTorch port on the CPU: the train step
over two gloo ranks (`parallel/launch.run_ranks`) against the JAX step.

The port's dp=2 step against the JAX `make_train_step` on a dp=2 mesh of
the virtual CPU devices, at batch 2 (one system per rank) with the JAX
step's draws through the step's `draws` seam, at the limits and with the
eps/lr device of tests/test_torch_train.py::step_parity (Adam eps 1, lr
1e3, EMA decay 0.5: every quantity compares at the gradient's limit).
The dp=2 step against the port's own dp=1 step, and the train CLI in two
processes: tests/test_torch_dp_cli.py.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as ttrain
import torch_ranks
from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.parallel.mesh import batch_sharding, make_mesh
from physdock_tpu.train import checkpoint as jax_ckpt
from physdock_tpu.train import optim as jax_optim
from physdock_tpu.train import step as jax_step
from physdock_tpu_torch.parallel.launch import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
DP, N_AUG = 2, 2
PARITY_OPT = dict(peak_lr=1e3, warmup_steps=1, eps=1.0)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends: a train state or a
    checkpoint written here takes hundreds of MB, and pytest keeps the
    directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _singles():
    return [make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=s)
            for s in (0, 1)]


def _stack(singles):
    return {k: torch.from_numpy(np.stack([np.asarray(s[k]) for s in singles]))
            for k in singles[0]}


def _jax_dp_step(singles, key):
    """The JAX step on a dp=2 mesh of the virtual devices; (logs, the
    state after it as state_dicts, the draws of each global system)."""
    jcfg = JaxConfig.named("toy", num_augmentation_sample=N_AUG)
    jm = JaxPhysDock(cfg=jcfg.model)
    params = jax_ckpt.load_params_npz(NPZ)
    # the dp step folds the global system index into the key: the draws of
    # system i are those of fold_in(key, i), as at dp=1
    draws = ttrain._jax_draws(jm, params, singles, key, False)
    mesh = make_mesh(dp=DP, devices=jax.devices()[:DP])
    jopt = jax_optim.make_optimizer(**PARITY_OPT)
    jstep = jax_step.make_train_step(jm, jopt, jcfg.loss, mesh, ema_decay=0.5,
                                     sigma_data=jcfg.model.sigma_data)
    stacked = {k: np.stack([np.asarray(s[k]) for s in singles]) for k in singles[0]}
    jbatch = jax.device_put({k: jnp.asarray(v) for k, v in stacked.items()},
                            batch_sharding(mesh))
    p0 = ttrain._flat(params)
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = jstep(jax_step.init_train_state(params, jopt), jbatch, key)
    adam = jstate.opt_state[1]
    ref = {"params": ttrain._flat(jstate.params), "mu": ttrain._flat(adam.mu),
           "nu": ttrain._flat(adam.nu), "ema": ttrain._flat(jstate.ema_params)}
    return {k: float(v) for k, v in jlogs.items()}, ref, p0, draws


def _blob(tmp_path, singles, **kw):
    path = os.path.join(tmp_path, "blob.pt")
    torch.save(dict(npz=NPZ, n_aug=N_AUG, opt=PARITY_OPT, ema_decay=0.5,
                    batch=_stack(singles), seed=11, **kw), path)
    return path


def test_dp2_step_matches_jax_dp2_step(tmp_path):
    torch.set_num_threads(1)
    singles = _singles()
    jlogs, ref, p0, draws = _jax_dp_step(singles, jax.random.PRNGKey(7))
    ranks = run_ranks(torch_ranks.dp_step, DP, args=(_blob(tmp_path, singles, draws=draws),),
                      rdv_dir=str(tmp_path / "rdv"))
    for r in ranks:
        changes = {}
        for q in ref:
            base = p0 if q in ("params", "ema") else {n: torch.zeros_like(t)
                                                      for n, t in p0.items()}
            changes[q] = ({n: ref[q][n] - base[n] for n in base},
                          {n: r[q][n].float() - base[n] for n in base})
        ttrain.check_step_parity(jlogs, r["logs"], changes)
