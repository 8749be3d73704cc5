"""Synthetic feature batches for tests and benchmarks.

Generates a self-consistent protein+ligand system with the exact device
feature contract (data/schema.py) at arbitrary (tokens, atoms, msa) sizes —
the fake-data analog of the reference demo systems, used by unit tests,
the compile-check entry point, and bench.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from physdock_tpu_torch.data.schema import FEATURE_SCHEMA, validate_batch


def make_synthetic_batch(
    n_tokens: int = 32,
    n_atoms: int = 96,
    n_msa: int = 8,
    n_ligand_tokens: int = 8,
    seed: int = 0,
    pad_tokens: int = 0,
    pad_atoms: int = 0,
) -> Dict[str, np.ndarray]:
    """Build a consistent fake system.

    Ligand tokens are one atom per token (as in the reference tokenization);
    protein tokens share the remaining atoms in contiguous chunks.
    `pad_tokens`/`pad_atoms` add zero-masked padding (static-shape buckets).
    """
    rng = np.random.default_rng(seed)
    n_prot = n_tokens - n_ligand_tokens
    assert n_prot > 0 and n_atoms > n_tokens

    # chunk sizes: ligand tokens 1 atom; protein tokens split the rest
    n_lig_atoms = n_ligand_tokens
    n_prot_atoms = n_atoms - n_lig_atoms
    base = n_prot_atoms // n_prot
    sizes = np.full(n_prot, base, np.int32)
    sizes[: n_prot_atoms - base * n_prot] += 1
    chunk_sizes = np.concatenate([sizes, np.ones(n_ligand_tokens, np.int32)])

    atom_tok = np.repeat(np.arange(n_tokens, dtype=np.int32), chunk_sizes)
    starts = np.concatenate([[0], np.cumsum(chunk_sizes)[:-1]]).astype(np.int32)

    is_ligand = (np.arange(n_tokens) >= n_prot).astype(np.float32)
    is_protein = 1.0 - is_ligand

    # plausible 3D structure: protein walk + ligand blob near the end
    x_gt = np.cumsum(rng.normal(0, 1.2, (n_atoms, 3)), axis=0).astype(np.float32)
    lig_centre = x_gt[starts[n_prot - 1]]
    x_gt[n_prot_atoms:] = lig_centre + rng.normal(0, 2.0, (n_lig_atoms, 3))

    ref_pos = x_gt + rng.normal(0, 0.5, x_gt.shape).astype(np.float32)

    centre_atom = (starts + chunk_sizes // 2).astype(np.int32)
    pseudo_beta = np.minimum(centre_atom + 1, np.cumsum(chunk_sizes) - 1).astype(np.int32)

    token_bonds = np.zeros((n_tokens, n_tokens), np.float32)
    for i in range(n_prot, n_tokens - 1):
        token_bonds[i, i + 1] = token_bonds[i + 1, i] = 1.0

    # fat one-hot features built with the REAL structure (one-hot + flag
    # channels) so the compact int8 transport round-trips exactly
    templ_mask = is_protein[:, None] * is_protein[None, :]
    templ_bins = rng.integers(0, 39, (n_tokens, n_tokens))
    templ = np.eye(39, dtype=np.float32)[templ_bins] * templ_mask[..., None]
    templ = np.concatenate([templ, templ_mask[..., None]], axis=-1)

    msa_tok = rng.integers(0, 32, (n_msa, n_tokens))
    msa_del = np.where(rng.random((n_msa, n_tokens)) < 0.1,
                       rng.integers(1, 9, (n_msa, n_tokens)), 0)
    msa_feat = np.concatenate(
        [
            np.eye(32, dtype=np.float32)[msa_tok],
            np.clip(msa_del, 0, 1).astype(np.float32)[..., None],
            (np.arctan(msa_del / 3.0) * (2.0 / np.pi)).astype(np.float32)[..., None],
        ],
        axis=-1,
    )

    d_tok = np.minimum(
        np.abs(np.arange(n_tokens)[:, None] - np.arange(n_tokens)[None]), 31
    )
    same_conf = (d_tok == 0).astype(np.float32)
    rel_bond_type = rng.integers(0, 5, (n_tokens, n_tokens))
    rel = np.concatenate(
        [
            np.eye(32, dtype=np.float32)[d_tok] * same_conf[..., None],
            np.eye(5, dtype=np.float32)[rel_bond_type] * token_bonds[..., None],
            token_bonds[..., None],  # bonded
            token_bonds[..., None] * 1.5,  # order-as-double
            (token_bonds * (rng.random((n_tokens, n_tokens)) < 0.5))[..., None],
            (token_bonds * (rng.random((n_tokens, n_tokens)) < 0.5))[..., None],
            (token_bonds * (rng.random((n_tokens, n_tokens)) < 0.5))[..., None],
        ],
        axis=-1,
    ).astype(np.float32)

    batch = {
        "residue_index": np.arange(n_tokens, dtype=np.int32),
        "restype": rng.integers(0, 21, n_tokens).astype(np.int32),
        "token_index": np.arange(n_tokens, dtype=np.int32),
        "s_mask": np.ones(n_tokens, np.float32),
        "is_protein": is_protein,
        "is_rna": np.zeros(n_tokens, np.float32),
        "is_dna": np.zeros(n_tokens, np.float32),
        "is_ligand": is_ligand,
        "is_key_res": (rng.random(n_tokens) < 0.1).astype(np.float32) * is_protein,
        "token_id_to_centre_atom_id": centre_atom,
        "token_id_to_pseudo_beta_atom_id": pseudo_beta,
        # 3-atom frames: (centre-1, centre, centre+1) clipped — distinct
        # atoms wherever the token has neighbors (enough for PAE/FAPE tests)
        "token_id_to_frame_atom_id_0": np.maximum(centre_atom - 1, 0),
        "token_id_to_frame_atom_id_1": centre_atom,
        "token_id_to_frame_atom_id_2": np.minimum(centre_atom + 1, n_atoms - 1),
        "token_id_to_chunk_sizes": chunk_sizes,
        "asym_id": (is_ligand).astype(np.int32),
        "entity_id": (is_ligand).astype(np.int32),
        "sym_id": np.zeros(n_tokens, np.int32),
        "token_bonds": token_bonds,
        "token_bonds_feature": token_bonds,
        "target_feat": rng.normal(0, 1, (n_tokens, 65)).astype(np.float32),
        "key_res_feat": rng.normal(0, 1, (n_tokens, 7)).astype(np.float32),
        "pocket_res_feat": (rng.random(n_tokens) < 0.2).astype(np.float32),
        "rel_tok_feat": rel,
        "ref_space_uid": atom_tok.copy(),
        "ref_feat": rng.normal(0, 1, (n_atoms, 167)).astype(np.float32),
        "ref_pos": ref_pos,
        "a_mask": np.ones(n_atoms, np.float32),
        "atom_id_to_token_id": atom_tok,
        "x_gt": x_gt,
        "x_exists": np.ones(n_atoms, np.float32),
        "msa_feat": msa_feat,
        "templ_feat": templ,
        "t_mask": np.float32(1.0),
    }
    batch["z_mask"] = batch["s_mask"][None] * batch["s_mask"][:, None]
    batch["ap_mask"] = batch["a_mask"][None] * batch["a_mask"][:, None]

    if pad_tokens or pad_atoms:
        batch = pad_batch(batch, n_tokens + pad_tokens, n_atoms + pad_atoms)
    validate_batch(batch)
    return batch


def pad_batch(
    batch: Dict[str, np.ndarray], n_tokens: int, n_atoms: int
) -> Dict[str, np.ndarray]:
    """Zero-pad a batch to static (n_tokens, n_atoms) bucket sizes.

    Padded atoms map to the last (padded) token; padded tokens have chunk
    size 0, so the cumsum-diff pooling produces zeros for them.
    """
    t0 = batch["s_mask"].shape[0]
    a0 = batch["a_mask"].shape[0]
    dt, da = n_tokens - t0, n_atoms - a0
    assert dt >= 0 and da >= 0
    out = {}
    for key, arr in batch.items():
        spec = FEATURE_SCHEMA[key]
        arr = np.asarray(arr)
        pads = []
        for axis_name in spec:
            if axis_name == "num_tokens":
                pads.append((0, dt))
            elif axis_name == "num_atoms":
                pads.append((0, da))
            else:
                pads.append((0, 0))
        out[key] = np.pad(arr, pads) if pads else arr
    # keep index maps in-range / pointing at padding
    if da:
        out["atom_id_to_token_id"][a0:] = n_tokens - 1 if dt else t0 - 1
    if dt:
        # padded tokens' atom index maps point at a PADDED atom when one
        # exists (x_exists=0 there keeps them out of token-existence masks
        # in the pde/pae/plddt losses)
        pad_atom = a0 if da else 0
        for k in (
            "token_id_to_centre_atom_id",
            "token_id_to_pseudo_beta_atom_id",
            "token_id_to_frame_atom_id_0",
            "token_id_to_frame_atom_id_1",
            "token_id_to_frame_atom_id_2",
        ):
            if k in out:
                out[k][t0:] = pad_atom
    return out
