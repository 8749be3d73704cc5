"""The train step's CUDA-graph option (`make_train_step(cuda_graph=True)`)
on the CPU, without JAX.

On the card the option replays each system's forward and backward as CUDA
graphs (held against the eager step bit for bit by `chip_smoke.py` phase
9d and `tests/test_torch_gpu.py`). A CPU batch takes the eager path, so
here a step with the option equals a step without it, bit for bit
(every loss term and every parameter); and the option refuses the steps
it does not cover: the mini-rollout and a process group.
"""

import copy
import os

import numpy as np
import pytest
import torch

from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.synthetic import make_synthetic_batch
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.parallel.mesh import Mesh
from physdock_tpu_torch.train import optim
from physdock_tpu_torch.train.step import init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
CFG = PhysDockConfig.named("toy", num_augmentation_sample=2)


def _batch():
    single = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6, seed=3)
    return {k: torch.from_numpy(np.asarray(v))[None] for k, v in single.items()}


def _steps(model, cuda_graph, n=1):
    model = copy.deepcopy(model)
    opt = optim.make_optimizer(1e-3, 100)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, CFG.loss, sigma_data=CFG.model.sigma_data,
                           cuda_graph=cuda_graph)
    batch, logs = _batch(), []
    for _ in range(n):
        state, lg = step(state, batch, 7)
        logs.append(lg)
    return state, logs


def test_cuda_graph_on_a_cpu_batch_is_the_eager_step():
    torch.set_num_threads(2)
    model = PhysDock(CFG.model)
    load_jax_params(model, NPZ)
    eager, eager_logs = _steps(model, False)
    graphed, graph_logs = _steps(model, True)
    assert graph_logs == eager_logs
    assert all(np.isfinite(v) for lg in eager_logs for v in lg.values())
    for n, p in eager.params.items():
        assert torch.equal(p, graphed.params[n]), n
    for n, p in eager.ema_params.items():
        assert torch.equal(p, graphed.ema_params[n]), n


@pytest.mark.parametrize("kwargs", [{"use_mini_rollout": True},
                                    {"mesh": Mesh(dp=1, tp=1, dp_rank=0, tp_rank=0)}])
def test_cuda_graph_refuses_the_steps_it_does_not_cover(kwargs):
    with pytest.raises(ValueError, match="cuda_graph"):
        make_train_step(None, optim.make_optimizer(1e-3, 100), CFG.loss, cuda_graph=True,
                        **kwargs)
