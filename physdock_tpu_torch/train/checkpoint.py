"""Train-state checkpoints and the flat `.npz` parameter artifact (port of
`physdock_tpu/train/checkpoint.py`).

Reference contract (train.sh:95-98,109 + utils/import_weights.py): save
every N updates keeping K, store both raw and EMA params, resume picks EMA
first.  The train state goes through `torch.save` (one `step_<N>.pt` file,
written to a temporary name and renamed, so a crash mid-save leaves no
partial checkpoint).  `save_params_npz` / `load_params_npz` write and read
the JAX package's flat `.npz` layout through the weight bridge, so the
port's EMA weights load into the JAX package and the JAX package's into
the port.  A model with the confidence head carries it through both, by
name like every other module.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from physdock_tpu_torch.model.weights import (
    jax_flat_to_state_dict,
    load_npz,
    state_dict_to_jax_flat,
)
from physdock_tpu_torch.train.optim import AdamState
from physdock_tpu_torch.train.step import TrainState

_CKPT = re.compile(r"^step_(\d{8})\.pt$")


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in tree.items()}


def save_train_state(ckpt_dir: str, state: TrainState, keep: int = 40) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{state.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({
        "step": state.step,
        "params": _cpu(state.params),
        "opt_state": {"count": state.opt_state.count, "mu": _cpu(state.opt_state.mu),
                      "nu": _cpu(state.opt_state.nu)},
        "ema_params": _cpu(state.ema_params),
    }, tmp)
    os.replace(tmp, path)
    _prune(ckpt_dir, keep)
    return path


def _checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir) if _CKPT.match(d))


def _prune(ckpt_dir: str, keep: int) -> None:
    for d in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, d))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpts = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_train_state(saved, state: TrainState, path: Optional[str] = None) -> TrainState:
    """Load a saved train state (its path, or the file already read, then
    named by `path`) into `state`'s tensors (the model's Parameters, the
    Adam moments and the EMA, on their devices); every name must match."""
    if isinstance(saved, str):
        path, saved = saved, torch.load(saved, map_location="cpu", weights_only=True)

    def fill(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
        if set(dst) != set(src):
            raise KeyError(f"{path}: {what} names differ from the model's: "
                           f"missing {sorted(set(dst) - set(src))[:4]}, "
                           f"unknown {sorted(set(src) - set(dst))[:4]}")
        with torch.no_grad():
            for n, t in dst.items():
                t.copy_(src[n])

    fill(state.params, saved["params"], "params")
    fill(state.ema_params, saved["ema_params"], "ema_params")
    opt = saved["opt_state"]
    fill(state.opt_state.mu, opt["mu"], "adam mu")
    fill(state.opt_state.nu, opt["nu"], "adam nu")
    return TrainState(int(saved["step"]), state.params,
                      AdamState(int(opt["count"]), state.opt_state.mu, state.opt_state.nu),
                      state.ema_params)


def save_params_npz(path: str, params: Dict[str, torch.Tensor], dtype=np.float16) -> None:
    """Save a state_dict as the JAX package's flat `.npz` (keys
    `params/...`, scanned stacks stacked). float16 by default, as there:
    more mantissa bits than bf16, half the bytes of fp32; weight magnitudes
    are far inside fp16 range (guarded here)."""
    out = {}
    for k, v in state_dict_to_jax_flat(params).items():
        if dtype is not None and v.dtype in (np.float32, np.float64):
            assert np.all(np.abs(v[np.isfinite(v)]) < 6e4), f"{k} overflows fp16"
            v = v.astype(dtype)
        out[k] = v
    np.savez_compressed(path, **out)


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flat JAX `.npz` as a port state_dict (fp32)."""
    return jax_flat_to_state_dict(load_npz(path))
