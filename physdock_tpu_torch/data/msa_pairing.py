"""Cross-chain MSA pairing and merging.

Re-implementation of the AF-Multimer-style pairing used by the reference
(data/tools/msa_pairing.py + feature_processing_multimer.py:52-120):

  * paired block: for each species present in >=2 chains' uniprot MSAs
    (`msa_all_seq` + `msa_species_identifiers_all_seq`), rank that species'
    rows per chain by gap fraction and pair k-th best across chains; chains
    missing the species contribute an all-GAP row;
  * unpaired block: each chain's main MSA laid out block-diagonally, other
    chains filled with GAP (=31);
  * row 0 is the concatenated query; dedup; cap at MSA_CROP_SIZE.

Ligand chains carry a trivial 2-row MSA of their restype row
(feature_loader.py:209-213) and never pair.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MSA_GAP_IDX = 31
MSA_CROP_SIZE = 16384
MAX_PAIRED_PER_SPECIES = 600


def _species_index(chain: Dict) -> Dict[bytes, np.ndarray]:
    """species id -> row indices into msa_all_seq, ranked by gap fraction."""
    species = chain["msa_species_identifiers_all_seq"]
    msa = chain["msa_all_seq"]
    gap_frac = np.mean(msa == MSA_GAP_IDX, axis=-1)
    out: Dict[bytes, List[int]] = {}
    for row, sp in enumerate(species):
        if not sp:
            continue
        out.setdefault(sp, []).append(row)
    return {
        sp: np.array(sorted(rows, key=lambda r: gap_frac[r]), np.int64)
        for sp, rows in out.items()
    }


def paired_rows_by_species(chains: Sequence[Dict]) -> List[np.ndarray]:
    """Per-chain row indices of the paired block (index -1 = all-GAP row).

    (reference: msa_pairing.py:76-262, pair_sequences/reorder_paired_rows)
    """
    indexes = [
        _species_index(c) if "msa_all_seq" in c else {} for c in chains
    ]
    all_species = set()
    for ix in indexes:
        all_species.update(ix.keys())

    per_chain: List[List[int]] = [[0] for _ in chains]  # row 0 pairs queries
    # species covering more chains first, then larger depth
    def species_order(sp):
        present = [sp in ix for ix in indexes]
        return (-sum(present), sp)

    for sp in sorted(all_species, key=species_order):
        present = [ix.get(sp) for ix in indexes]
        n_present = sum(1 for p in present if p is not None)
        if n_present < 2:
            continue
        depth = min(
            min(len(p) for p in present if p is not None), MAX_PAIRED_PER_SPECIES
        )
        for k in range(depth):
            for ci, p in enumerate(present):
                per_chain[ci].append(int(p[k]) if p is not None else -1)

    return [np.array(rows, np.int64) for rows in per_chain]


def merge_msas(chains: Sequence[Dict], lengths: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Build the merged (msa, deletion_matrix) across chains.

    chains: per-chain dicts with msa/deletion_matrix (+ optional *_all_seq &
    species ids).  lengths: per-chain token counts.  Returns int arrays
    [N_merged, sum(lengths)].
    """
    n_chains = len(chains)
    total = int(sum(lengths))
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(int)

    blocks_msa, blocks_del = [], []

    # ---- paired block (only if >=2 chains carry uniprot MSAs) ----
    has_all_seq = [c for c in chains if "msa_all_seq" in c]
    if len(has_all_seq) >= 2:
        rows_per_chain = paired_rows_by_species(chains)
        depth = len(rows_per_chain[0])
        pm = np.full((depth, total), MSA_GAP_IDX, np.int8)
        pd = np.zeros((depth, total), np.int8)
        for ci, chain in enumerate(chains):
            sl = slice(offsets[ci], offsets[ci + 1])
            if "msa_all_seq" in chain:
                src = chain["msa_all_seq"]
                src_d = chain["deletion_matrix_all_seq"]
                rows = rows_per_chain[ci]
                valid = rows >= 0
                pm[valid, sl] = src[rows[valid]]
                pd[valid, sl] = src_d[rows[valid]]
            else:
                # ligand/unpairable chain: repeat its query row
                pm[:, sl] = chain["msa"][0][None]
        blocks_msa.append(pm)
        blocks_del.append(pd)

    # ---- unpaired block-diagonal ----
    for ci, chain in enumerate(chains):
        msa = np.asarray(chain["msa"], np.int8)
        dele = np.asarray(chain["deletion_matrix"], np.int8)
        start = 1 if blocks_msa else 0  # row 0 already covered by paired query
        if not blocks_msa and ci == 0:
            start = 0
        rows = msa.shape[0]
        bm = np.full((rows, total), MSA_GAP_IDX, np.int8)
        bd = np.zeros((rows, total), np.int8)
        sl = slice(offsets[ci], offsets[ci + 1])
        bm[:, sl] = msa
        bd[:, sl] = dele
        if ci == 0 and not blocks_msa:
            # ensure the first row is the full concatenated query
            for cj, other in enumerate(chains):
                if cj == ci:
                    continue
                bm[0, offsets[cj] : offsets[cj + 1]] = other["msa"][0]
        blocks_msa.append(bm)
        blocks_del.append(bd)

    msa = np.concatenate(blocks_msa, axis=0)
    dele = np.concatenate(blocks_del, axis=0)

    # dedup identical rows (keep order; reference dedups paired vs unpaired)
    _, keep = np.unique(msa, axis=0, return_index=True)
    keep = np.sort(keep)
    # always keep row 0 first
    if keep[0] != 0:
        keep = np.concatenate([[0], keep[keep != 0]])
    msa, dele = msa[keep], dele[keep]

    return msa[:MSA_CROP_SIZE], dele[:MSA_CROP_SIZE]


def msa_profile(msa: np.ndarray) -> np.ndarray:
    """Per-position 32-class profile (feature_loader.py:656-661)."""
    one_hot = np.eye(32, dtype=np.float32)[np.clip(msa, 0, 31).astype(np.int64)]
    return one_hot.mean(axis=0)


def deletion_mean(deletion_matrix: np.ndarray) -> np.ndarray:
    """atan-squashed column deletion mean (feature_loader.py:660-662)."""
    return (np.arctan(deletion_matrix.sum(axis=0) / 3.0) * (2.0 / np.pi)).astype(
        np.float32
    )
