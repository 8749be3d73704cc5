"""Compact host -> device feature transport (port of
`physdock_tpu/model/compact.py`).

The three fat conditioning inputs are one-hot/flag expansions rebuilt on
the device from int8 indices:

  * msa_feat     [N, T, 34] = one_hot(32) + has_deletion + deletion_value
  * rel_tok_feat [T, T, 42] = d_token 1-hot(32) + bond-type 1-hot(5) +
                   bonded/as-double/in-ring/conjugated/aromatic
  * templ_feat   [T, T, 40] = 39-bin distogram 1-hot + mask

`compact_batch_np` (host, numpy) recovers the indices from the one-hots
(exact; all-zero rows -> -1, which re-expands to zeros); `expand_batch`
(device, torch) rebuilds the f32 features.  `pad_compact_np` and
`pad_compact_msa_np` re-pad a compact batch to a larger bucket, for a
group of systems docked in one sampler pass.  The NumPy half imports no
torch (the featurizer worker compacts without it).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FAT_KEYS = ("msa_feat", "rel_tok_feat", "templ_feat")


def _onehot_to_idx(oh: np.ndarray) -> np.ndarray:
    """[..., C] one-hot -> int8 index with -1 for all-zero rows."""
    idx = oh.argmax(-1).astype(np.int8)
    return np.where(oh.sum(-1) > 0, idx, np.int8(-1))


def compact_msa_np(msa_feat: np.ndarray) -> Dict[str, np.ndarray]:
    mf = np.asarray(msa_feat)
    return {
        "msa_tok_c": _onehot_to_idx(mf[..., :32]),
        "msa_del_c": np.round(mf[..., 33] * 255.0).astype(np.uint8),
    }


def compact_batch_np(feats: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side: strip fat f32 features + derived pair masks, add int8
    compacts."""
    out = {k: v for k, v in feats.items() if k not in FAT_KEYS + ("ap_mask", "z_mask")}
    out.update(compact_msa_np(feats["msa_feat"]))
    rel = np.asarray(feats["rel_tok_feat"])
    flags = (
        (rel[..., 37] > 0).astype(np.int8)
        | ((rel[..., 39] > 0).astype(np.int8) << 1)
        | ((rel[..., 40] > 0).astype(np.int8) << 2)
        | ((rel[..., 41] > 0).astype(np.int8) << 3)
    )
    out["rel_d_tok_c"] = _onehot_to_idx(rel[..., :32])
    out["rel_bond_type_c"] = _onehot_to_idx(rel[..., 32:37])
    out["rel_as_double_x2_c"] = np.round(rel[..., 38] * 2.0).astype(np.int8)
    out["rel_flags_c"] = flags
    tf = np.asarray(feats["templ_feat"])
    out["templ_bins_c"] = _onehot_to_idx(tf[..., :39])
    out["templ_mask_c"] = (tf[..., 39] > 0).astype(np.int8)
    return out


# compact transport keys: symbolic axes (S = MSA rows, T = tokens)
COMPACT_SCHEMA = {
    "msa_tok_c": ("S", "T"),
    "msa_del_c": ("S", "T"),
    "rel_d_tok_c": ("T", "T"),
    "rel_bond_type_c": ("T", "T"),
    "rel_as_double_x2_c": ("T", "T"),
    "rel_flags_c": ("T", "T"),
    "templ_bins_c": ("T", "T"),
    "templ_mask_c": ("T", "T"),
}
# index compacts pad with -1 (re-expands to all-zero one-hots, matching the
# fat features' zero padding); value/flag compacts pad with 0
_NEG_ONE_PAD = {"msa_tok_c", "rel_d_tok_c", "rel_bond_type_c", "templ_bins_c"}


def pad_compact_np(c: Dict[str, np.ndarray], n_tok: int, n_atom: int) -> Dict[str, np.ndarray]:
    """Re-pad a compact batch to larger (n_tok, n_atom) bucket sizes:
    schema keys through the featurizer's own `pad_batch` (index fixups
    included), compact keys with their one-hot-neutral fill."""
    from physdock_tpu_torch.data.schema import FEATURE_SCHEMA
    from physdock_tpu_torch.data.synthetic import pad_batch

    out = pad_batch({k: v for k, v in c.items() if k in FEATURE_SCHEMA}, n_tok, n_atom)
    for k, v in c.items():
        if k in FEATURE_SCHEMA:
            continue
        v = np.asarray(v)
        pads = [(0, n_tok - v.shape[i]) if ax == "T" else (0, 0)
                for i, ax in enumerate(COMPACT_SCHEMA[k])]
        out[k] = np.pad(v, pads, constant_values=-1 if k in _NEG_ONE_PAD else 0)
    return out


def pad_compact_msa_np(c: Dict[str, np.ndarray], n_tok: int) -> Dict[str, np.ndarray]:
    """Pad a per-round compact MSA dict's token axis."""
    tok, dele = np.asarray(c["msa_tok_c"]), np.asarray(c["msa_del_c"])
    return {
        "msa_tok_c": np.pad(tok, ((0, 0), (0, n_tok - tok.shape[1])), constant_values=-1),
        "msa_del_c": np.pad(dele, ((0, 0), (0, n_tok - dele.shape[1]))),
    }

def _idx_one_hot(idx, n):
    """int index -> f32 one-hot; -1 (or any out-of-range) -> zeros."""
    import torch

    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    oh = torch.nn.functional.one_hot(torch.where(valid, idx, 0), n).float()
    return oh * valid[..., None].float()


def expand_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device-side: rebuild the fat f32 features from compacts when absent."""
    if all(k in batch for k in FAT_KEYS):
        return batch
    import torch

    batch = dict(batch)
    if "msa_feat" not in batch and "msa_tok_c" in batch:
        oh = _idx_one_hot(batch["msa_tok_c"], 32)
        del_val = batch["msa_del_c"].float() / 255.0
        has_del = (del_val > 0).float()
        batch["msa_feat"] = torch.cat([oh, has_del[..., None], del_val[..., None]], dim=-1)
    if "rel_tok_feat" not in batch and "rel_d_tok_c" in batch:
        flags = batch["rel_flags_c"].int()
        batch["rel_tok_feat"] = torch.cat(
            [
                _idx_one_hot(batch["rel_d_tok_c"], 32),
                _idx_one_hot(batch["rel_bond_type_c"], 5),
                (flags & 1).float()[..., None],
                (batch["rel_as_double_x2_c"].float() / 2.0)[..., None],
                ((flags >> 1) & 1).float()[..., None],
                ((flags >> 2) & 1).float()[..., None],
                ((flags >> 3) & 1).float()[..., None],
            ],
            dim=-1,
        )
    if "templ_feat" not in batch and "templ_bins_c" in batch:
        batch["templ_feat"] = torch.cat(
            [_idx_one_hot(batch["templ_bins_c"], 39), batch["templ_mask_c"].float()[..., None]],
            dim=-1,
        )
    return batch
