"""Weight bridge between the JAX package's flat `.npz` parameters and the
port's `state_dict`.

The JAX artifact (`physdock_tpu/train/checkpoint.py::save_params_npz`) is
a flat dict `params/<module>/.../<leaf>`, with every stack's parameters
scanned: one array per leaf under `blocks/`, whose leading axis is the
block index.  The port names modules identically, holds one module per
block in a `ModuleList` (`blocks.<i>.`) and stores `Linear.weight` as
[out, in] where the JAX kernel is [in, out].  Every key is used exactly
once in each direction; anything left over or missing raises.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

PREFIX = "params/"


def _is_linear_weight(parts, arr) -> bool:
    # norm weights are 1-D; every 2-D `weight` leaf is a Linear kernel
    return parts[-1] == "weight" and arr.ndim == 2


def jax_flat_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX params (keys `params/...`) -> torch state_dict (fp32)."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        if not key.startswith(PREFIX):
            raise KeyError(f"unexpected parameter key {key!r}")
        parts = key[len(PREFIX):].split("/")
        arr = np.asarray(arr, np.float32)
        n_stacked = parts.count("blocks")
        if n_stacked > 1:
            raise KeyError(f"nested scanned stacks are not supported: {key!r}")
        if n_stacked:
            at = parts.index("blocks")
            per_block = [(parts[: at + 1] + [str(i)] + parts[at + 1:], arr[i])
                         for i in range(arr.shape[0])]
        else:
            per_block = [(parts, arr)]
        for p, a in per_block:
            name = ".".join(p)
            if name in out:
                raise KeyError(f"parameter {name!r} produced twice")
            if _is_linear_weight(p, a):
                a = a.T
            out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def state_dict_to_jax_flat(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """torch state_dict -> flat JAX params (the inverse of
    `jax_flat_to_state_dict`)."""
    stacked = defaultdict(dict)
    flat: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        a = t.detach().cpu().float().numpy()
        if _is_linear_weight(parts, a):
            a = a.T
        if "blocks" in parts:
            at = parts.index("blocks")
            i = int(parts[at + 1])
            key = PREFIX + "/".join(parts[: at + 1] + parts[at + 2:])
            if i in stacked[key]:
                raise KeyError(f"parameter {name!r} seen twice")
            stacked[key][i] = a
        else:
            flat[PREFIX + "/".join(parts)] = a
    for key, blocks in stacked.items():
        if sorted(blocks) != list(range(len(blocks))):
            raise KeyError(f"{key}: block indices {sorted(blocks)} are not 0..n-1")
        flat[key] = np.stack([blocks[i] for i in range(len(blocks))])
    return flat


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_jax_params(model: torch.nn.Module, path: str) -> None:
    """Load a JAX `.npz` into `model`, requiring every parameter of the
    file and of the model to be used exactly once."""
    sd = jax_flat_to_state_dict(load_npz(path))
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing[:8]} ({len(missing)}), "
                       f"unused {extra[:8]} ({len(extra)})")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: file shape {tuple(t.shape)} != model {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)
