"""Typed feature schema.

The device-batch contract between the host featurizer and the model
(equivalent of the reference's SHAPE_SCHIME registry —
PhysDock/data/__init__.py:50-100).  Axis placeholders:
  T = tokens, A = atoms, S = MSA rows, C = conformers.

Every model-facing batch is a flat dict of static-shaped arrays with these
keys; `validate_batch` checks presence and rank.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

T, A, S = "num_tokens", "num_atoms", "num_msa"

FEATURE_SCHEMA: Dict[str, tuple] = {
    # token-wise
    "residue_index": (T,),
    "restype": (T,),
    "token_index": (T,),
    "s_mask": (T,),
    "is_protein": (T,),
    "is_rna": (T,),
    "is_dna": (T,),
    "is_ligand": (T,),
    "is_key_res": (T,),
    "token_id_to_centre_atom_id": (T,),
    "token_id_to_pseudo_beta_atom_id": (T,),
    # 3-atom local frames for PAE/FAPE: protein (N, CA, C), ligand
    # (nearest, self, second-nearest) — consumed by model/losses.py
    "token_id_to_frame_atom_id_0": (T,),
    "token_id_to_frame_atom_id_1": (T,),
    "token_id_to_frame_atom_id_2": (T,),
    "token_id_to_chunk_sizes": (T,),
    "asym_id": (T,),
    "entity_id": (T,),
    "sym_id": (T,),
    "token_bonds": (T, T),
    "token_bonds_feature": (T, T),
    "target_feat": (T, 65),
    "key_res_feat": (T, 7),
    "pocket_res_feat": (T,),
    "rel_tok_feat": (T, T, 42),
    # atom-wise
    "ref_space_uid": (A,),
    "ref_feat": (A, 167),
    "ref_pos": (A, 3),
    "a_mask": (A,),
    "atom_id_to_token_id": (A,),
    "x_gt": (A, 3),
    "x_exists": (A,),
    # MSA
    "msa_feat": (S, T, 34),
    # pair masks (derived)
    "z_mask": (T, T),
    "ap_mask": (A, A),
    # template
    "templ_feat": (T, T, 40),
    "t_mask": (),
}

INT_FEATURES = {
    "residue_index",
    "restype",
    "token_index",
    "token_id_to_centre_atom_id",
    "token_id_to_pseudo_beta_atom_id",
    "token_id_to_frame_atom_id_0",
    "token_id_to_frame_atom_id_1",
    "token_id_to_frame_atom_id_2",
    "token_id_to_chunk_sizes",
    "asym_id",
    "entity_id",
    "sym_id",
    "ref_space_uid",
    "atom_id_to_token_id",
}


def validate_batch(batch: Dict[str, np.ndarray], strict: bool = False) -> None:
    missing = [k for k in FEATURE_SCHEMA if k not in batch]
    if missing:
        raise KeyError(f"batch missing features: {missing}")
    dims: Dict[str, int] = {}
    for key, spec in FEATURE_SCHEMA.items():
        arr = batch[key]
        if len(spec) != np.ndim(arr):
            raise ValueError(
                f"{key}: expected rank {len(spec)} ({spec}), got shape {np.shape(arr)}"
            )
        for axis, want in zip(np.shape(arr), spec):
            if isinstance(want, int):
                if axis != want:
                    raise ValueError(f"{key}: expected {spec}, got {np.shape(arr)}")
            else:
                if want in dims and dims[want] != axis:
                    raise ValueError(
                        f"{key}: inconsistent {want} ({dims[want]} vs {axis})"
                    )
                dims[want] = axis
