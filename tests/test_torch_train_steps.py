"""Twenty composed train steps of the PyTorch port against the JAX
package's, from one set of weights: a difference in the training path
that one step hides (tests/test_torch_train.py holds one step) would
grow over steps.

Both trainers run 20 steps at batch 2 on two synthetic systems from the
committed toy weights (`_overfit/ema_params.npz`). Each step's draws are
the JAX step's (`fold_in(k_step, i)` per system, through the port step's
`draws` seam), the keys split per step as the train CLI and the gate do.
The optimizer is `step_parity`'s device with a step the model survives:
Adam eps 1 (its update linear in the gradient, no sign(g) of a near-zero
entry to flip), lr 1 with one warmup step, EMA decay 0.5. After every
step, at the one-step limits of tests/test_torch_train.py::
check_step_parity, the difference must not grow: the loss terms within
rel 1e-4; the Adam moments, which carry every step's gradient (taken at
that step's parameters), within rel 1e-3 (nu 2e-3) by global norm and
per tensor; the change of the parameters and of the EMA from the start
within rel 1e-3 by global norm. (At lr 1 a tensor's change can sit
near its parameters' fp32 ulp, so the change is not held per tensor.
On the CPU every global difference stays near 1e-5 through the 20
steps.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_train as ttrain
from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.parallel.mesh import batch_sharding, make_mesh
from physdock_tpu.train import checkpoint as jax_ckpt
from physdock_tpu.train import optim as jax_optim
from physdock_tpu.train import step as jax_step
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.nn.transformers import set_remat
from physdock_tpu_torch.train import optim
from physdock_tpu_torch.train.step import init_train_state, make_train_step

STEPS, N_AUG = 20, 2
OPT = dict(peak_lr=1.0, warmup_steps=1, eps=1.0)


def test_twenty_steps_match_jax():
    torch.set_num_threads(2)
    singles = [make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=s)
               for s in (0, 1)]
    stacked = {k: np.stack([np.asarray(s[k]) for s in singles]) for k in singles[0]}

    jcfg = JaxConfig.named("toy", num_augmentation_sample=N_AUG)
    jm = JaxPhysDock(cfg=jcfg.model)
    params = jax_ckpt.load_params_npz(ttrain.NPZ)
    p0 = ttrain._flat(params)
    mesh = make_mesh(dp=1, devices=jax.devices()[:1])
    jopt = jax_optim.make_optimizer(**OPT)
    jstep = jax_step.make_train_step(jm, jopt, jcfg.loss, mesh, ema_decay=0.5,
                                     sigma_data=jcfg.model.sigma_data)
    jbatch = jax.device_put({k: jnp.asarray(v) for k, v in stacked.items()},
                            batch_sharding(mesh))
    # committed to the device as the step's outputs are: the step compiles once
    jstate = jax.device_put(jax_step.init_train_state(params, jopt), jax.devices()[0])

    cfg = PhysDockConfig.named("toy", num_augmentation_sample=N_AUG)
    model = PhysDock(cfg.model)
    load_jax_params(model, ttrain.NPZ)
    set_remat(model, False)  # as the gate trains: no recompute, the same numbers
    topt = optim.make_optimizer(**OPT)
    state = init_train_state(model, topt)
    step = make_train_step(model, topt, cfg.loss, ema_decay=0.5, sigma_data=cfg.model.sigma_data)
    tbatch = {k: torch.from_numpy(v) for k, v in stacked.items()}

    key = jax.random.PRNGKey(3)
    zeros = {n: torch.zeros_like(t) for n, t in p0.items()}
    for k in range(1, STEPS + 1):
        key, k_step = jax.random.split(key)
        # the draws of the JAX step's keys, from the JAX parameters of now
        draws = ttrain._jax_draws(jm, jstate.params, singles, k_step, False)
        with jax.default_matmul_precision("highest"):
            jstate, jlogs = jstep(jstate, jbatch, k_step)
        state, logs = step(state, tbatch, draws=draws)
        adam = jstate.opt_state[1]
        ref = {"params": ttrain._flat(jstate.params), "mu": ttrain._flat(adam.mu),
               "nu": ttrain._flat(adam.nu), "ema": ttrain._flat(jstate.ema_params)}
        got = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu,
               "ema": state.ema_params}
        changes = {}
        for q in ref:
            base = p0 if q in ("params", "ema") else zeros
            changes[q] = ({n: ref[q][n] - base[n] for n in base},
                          {n: got[q][n].detach().float() - base[n] for n in base})
        print(f"step {k}: loss JAX {float(jlogs['loss']):.6f} port {logs['loss']:.6f}")
        ttrain.check_step_parity({n: float(v) for n, v in jlogs.items()}, logs,
                                 {q: changes[q] for q in ("mu", "nu")})
        for q in ("params", "ema"):
            r, g = changes[q]
            diff = np.sqrt(sum(float(((g[n] - x).double() ** 2).sum()) for n, x in r.items()))
            total = np.sqrt(sum(float((x.double() ** 2).sum()) for x in r.values()))
            assert diff <= ttrain.REL_GRAD * total, (k, q, diff / total)
