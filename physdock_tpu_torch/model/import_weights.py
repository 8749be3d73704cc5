"""Reference checkpoint import: a PhysDock `params.pt` as the port's
`state_dict` (port of `physdock_tpu/model/import_weights.py`).

Contract from the reference PhysDock/utils/import_weights.py:
  * a flat release checkpoint: strip a leading `model.` from every key;
  * a Uni-Core training checkpoint: take ckpt["ema"]["params"] (else
    ckpt["model"]) and strip the prefix (`_orig_mod.model.` for compiled
    modules).

The port's modules carry the reference's names and store `Linear.weight`
[out, in] as torch does, so the conversion is one rename: the reference
nests `time_embedder.timestep_embedder.linear_{1,2}`, the port (like the
JAX package) has `time_embedder.linear_{1,2}`.  No transpose, no stacking.

`load_weights` is the one loader of the entry points: a JAX `.npz`
artifact goes through the weight bridge (`model/weights.py`); any other
file is read with `torch.load` and dispatched on its content: the port's
own train state (`train/checkpoint.py`: `step`, `params`, `opt_state`,
`ema_params`) gives its EMA weights, as the JAX `restore_params` prefers
the EMA; everything else is a reference checkpoint.  Every key is used
exactly once either way; a model without the confidence head leaves a
file's head keys unused and counts them.  A checkpoint is unpickled in
full (Uni-Core files hold more than tensors), so load only trusted files.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from physdock_tpu_torch.model.weights import (
    HEAD,
    counts,
    load_jax_params,
    load_state_dict_checked,
    split_head,
)

TRAIN_STATE_KEYS = frozenset({"step", "params", "opt_state", "ema_params"})
_PREFIXES = ("model.", "_orig_mod.model.")  # stripped in this order, as in JAX


def read_checkpoint(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def is_train_state(ckpt) -> bool:
    """The port's own train-state file (`train/checkpoint.py`)."""
    return isinstance(ckpt, dict) and TRAIN_STATE_KEYS <= set(ckpt)


def load_torch_state_dict(ckpt) -> Dict[str, torch.Tensor]:
    """A reference checkpoint (a path, or what `torch.load` gave) as a flat
    fp32 state dict with the reference's module names, prefixes stripped."""
    if isinstance(ckpt, str):
        ckpt = read_checkpoint(ckpt)
    if isinstance(ckpt, dict) and "ema" in ckpt:
        state = ckpt["ema"].get("params", ckpt.get("model"))
        if state is None:
            raise ValueError(
                "Uni-Core checkpoint has an 'ema' key but neither "
                "ckpt['ema']['params'] nor ckpt['model'] exists; expected "
                "the train.sh layout {'ema': {'params': state_dict}, ...} "
                f"(got ema keys {sorted(ckpt['ema'])[:8]}, "
                f"top-level keys {sorted(ckpt)[:8]})"
            )
    elif isinstance(ckpt, dict) and "model" in ckpt and not any(
        hasattr(v, "numpy") for v in list(ckpt.values())[:3]
    ):
        state = ckpt["model"]
    else:
        state = ckpt
    out = {}
    for k, v in state.items():
        for prefix in _PREFIXES:
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v.detach().float() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return out


def rewrite_key(key: str) -> str:
    """Reference name -> port name."""
    key = key.replace(".timestep_embedder.linear_1", ".linear_1")
    return key.replace(".timestep_embedder.linear_2", ".linear_2")


def convert_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state dict under the port's names."""
    out: Dict[str, torch.Tensor] = {}
    for key, t in state.items():
        name = rewrite_key(key)
        if name in out:
            raise KeyError(f"reference keys {key!r} and another both map to {name!r}")
        out[name] = t
    return out


def import_checkpoint(ckpt) -> Dict[str, torch.Tensor]:
    """Load and convert a reference checkpoint (a path or its loaded dict)."""
    return convert_state_dict(load_torch_state_dict(ckpt))


def audit_conversion(converted: Mapping[str, torch.Tensor], model_sd: Mapping[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str], List[Tuple[str, tuple, tuple]]]:
    """(missing, unexpected, mismatched) of a converted checkpoint against
    a model's state_dict: names the model has and the file lacks, names
    the file has and the model lacks, and (name, file shape, model shape)
    where both have the name with different shapes."""
    missing = sorted(set(model_sd) - set(converted))
    unexpected = sorted(set(converted) - set(model_sd))
    mismatched = [(n, tuple(converted[n].shape), tuple(model_sd[n].shape))
                  for n in sorted(set(model_sd) & set(converted))
                  if tuple(converted[n].shape) != tuple(model_sd[n].shape)]
    return missing, unexpected, mismatched


def load_weights(model: torch.nn.Module, path: str, ckpt=None) -> Dict[str, int]:
    """Load `path` into `model` (`ckpt`: the file already read with
    `read_checkpoint`); returns the counts of `model/weights.py`."""
    if path.endswith(".npz"):
        return load_jax_params(model, path)
    if ckpt is None:
        ckpt = read_checkpoint(path)
    sd = dict(ckpt["ema_params"]) if is_train_state(ckpt) else import_checkpoint(ckpt)
    unused = split_head(model, sd, HEAD + ".", path)
    load_state_dict_checked(model, sd, path)
    return counts(len(sd), unused)

