"""Weight bridge between the JAX package's flat `.npz` parameters and the
port's `state_dict`.

The JAX artifact (`physdock_tpu/train/checkpoint.py::save_params_npz`) is
a flat dict `params/<module>/.../<leaf>`, with every stack's parameters
scanned: one array per leaf under `blocks/`, whose leading axis is the
block index.  The port names modules identically, holds one module per
block in a `ModuleList` (`blocks.<i>.`) and stores `Linear.weight` as
[out, in] where the JAX kernel is [in, out].  Every key is used exactly
once in each direction; anything left over or missing raises, with one
exception that the JAX CLI also makes: a model built without the
confidence head loads a file that has one, and the head's keys are left
unused and counted.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

PREFIX = "params/"
HEAD = "confidence_module"  # the optional confidence head's module name


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


def load_state_dict_checked(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                            source: str) -> None:
    """Load a port-named state_dict into `model`, requiring every parameter
    of `sd` and of the model to be used exactly once, with equal shapes."""
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"{source}: weight bridge mismatch: missing {missing[:8]} "
                       f"({len(missing)}), unused {extra[:8]} ({len(extra)})")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: file shape {tuple(t.shape)} != model {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)


def split_head(model: torch.nn.Module, params: Dict, head_prefix: str, source: str) -> Dict:
    """Set a file's confidence-head entries (names starting `head_prefix`)
    aside when `model` has no head, and return them; when it has one, a
    file without the head raises ValueError."""
    head_keys = sorted(k for k in params if k.startswith(head_prefix))
    if any(n.startswith(HEAD + ".") for n in model.state_dict()):
        if not head_keys:
            raise ValueError(f"the confidence head (--enable_confidence, --confidence_ranking, "
                             f"--use_mini_rollout) needs params trained with it; {source} has "
                             f"none")
        return {}
    return {k: params.pop(k) for k in head_keys}


def counts(n_keys: int, unused: Dict) -> Dict[str, int]:
    return {"keys": n_keys, "unused_head_keys": len(unused),
            "unused_head_params": int(sum(math.prod(v.shape) for v in unused.values()))}


def load_jax_params(model: torch.nn.Module, path: str) -> Dict[str, int]:
    """Load a JAX `.npz` into `model`, requiring every parameter of the
    file and of the model to be used exactly once; when the model has no
    confidence head, the file's head keys are set aside first, and when it
    has one, a file without it raises ValueError. Returns
    the counts: keys loaded, and head keys and parameters left unused."""
    flat = load_npz(path)
    unused = split_head(model, flat, PREFIX + HEAD + "/", path)
    load_state_dict_checked(model, jax_flat_to_state_dict(flat), path)
    return counts(len(flat), unused)
