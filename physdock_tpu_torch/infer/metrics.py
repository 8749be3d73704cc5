"""Post-hoc confidence metrics (NumPy).

Port of reference PhysDock/data/tools/get_metrics.py: pLDDT expectation,
PAE expectation, pTM/ipTM with d0 interpolation, inter-chain clash
detection, and the ranking confidence 0.8*ipTM + 0.2*pTM - has_clash.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _softmax(x, axis=-1):
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)


def _bin_centers(breaks: np.ndarray) -> np.ndarray:
    step = breaks[1] - breaks[0]
    centers = breaks + step / 2
    return np.concatenate([centers, [centers[-1] + step]])


def compute_plddt(logits: np.ndarray) -> np.ndarray:
    """[N, bins] pLDDT logits -> per-atom pLDDT in [0, 100]
    (get_metrics.py:63-78)."""
    num_bins = logits.shape[-1]
    width = 1.0 / num_bins
    centers = np.arange(0.5 * width, 1.0, width)
    probs = _softmax(logits, axis=-1)
    return np.sum(probs * centers, axis=-1) * 100


def compute_predicted_aligned_error(
    logits: np.ndarray, breaks: np.ndarray
) -> Dict[str, np.ndarray]:
    """PAE expectation over bins (get_metrics.py:139-167)."""
    probs = _softmax(logits, axis=-1)
    centers = _bin_centers(breaks)
    return {
        "aligned_confidence_probs": probs,
        "predicted_aligned_error": np.sum(probs * centers, axis=-1),
        "max_predicted_aligned_error": centers[-1],
    }


def predicted_tm_score(
    logits: np.ndarray,
    breaks: np.ndarray,
    residue_weights: Optional[np.ndarray] = None,
    asym_id: Optional[np.ndarray] = None,
    interface: bool = False,
) -> float:
    """pTM / ipTM from PAE logits (get_metrics.py:79-137)."""
    if residue_weights is None:
        residue_weights = np.ones(logits.shape[0])
    centers = _bin_centers(breaks)
    num_res = int(np.sum(residue_weights))
    clipped = max(num_res, 19)
    d0 = 1.24 * (clipped - 15) ** (1.0 / 3) - 1.8
    probs = _softmax(logits, axis=-1)
    tm_per_bin = 1.0 / (1.0 + np.square(centers) / np.square(d0))
    predicted_tm = np.sum(probs * tm_per_bin, axis=-1)

    pair_mask = np.ones_like(predicted_tm, bool)
    if interface:
        assert asym_id is not None
        pair_mask = asym_id[:, None] != asym_id[None, :]
    predicted_tm = predicted_tm * pair_mask
    pair_weights = pair_mask * (
        residue_weights[None, :] * residue_weights[:, None]
    )
    denom = np.sum(pair_weights, axis=-1, keepdims=True)
    normed = pair_weights / (1e-8 + denom)
    per_align = np.sum(predicted_tm * normed, axis=-1)
    weighted = per_align * residue_weights
    return float(weighted[np.argmax(weighted)])


def get_has_clash(atom_pos, atom_mask, asym_id, is_polymer_chain) -> int:
    """Inter-chain polymer clash flag: >100 clashes at 1.1 A or ratio > 0.5
    (get_metrics.py:169-197)."""
    flag = (atom_mask == 1) & (is_polymer_chain == 1)
    atom_pos = atom_pos[flag]
    asym_id = np.asarray(asym_id)[flag]
    ids = np.unique(asym_id)
    if len(ids) <= 1:
        return 0
    for i, a1 in enumerate(ids[:-1]):
        for a2 in ids[i + 1 :]:
            p1, p2 = atom_pos[asym_id == a1], atom_pos[asym_id == a2]
            d = np.sqrt(np.sum((p1[None] - p2[:, None]) ** 2, -1))
            n_clash = float(np.sum(d < 1.1))
            if n_clash > 100 or n_clash / min(len(p1), len(p2)) > 0.5:
                return 1
    return 0


def get_metrics(
    p_pae: np.ndarray,
    p_plddt: np.ndarray,
    x_pred: np.ndarray,
    feats: Dict[str, np.ndarray],
    pae_breaks: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Full metric set incl. ranking_confidence = 0.8*ipTM + 0.2*pTM -
    has_clash (get_metrics.py:260-278)."""
    if pae_breaks is None:
        pae_breaks = np.linspace(0.0, 31.5, p_pae.shape[-1] - 1)
    s_mask = np.asarray(feats["s_mask"])
    asym = np.asarray(feats["asym_id"])
    tok = np.asarray(feats["atom_id_to_token_id"])
    metrics = {
        "mean_plddt": float(np.mean(compute_plddt(p_plddt))),
        "ptm": predicted_tm_score(p_pae, pae_breaks, s_mask),
        "iptm": predicted_tm_score(
            p_pae, pae_breaks, s_mask, asym_id=asym, interface=True
        ),
    }
    metrics["has_clash"] = get_has_clash(
        np.asarray(x_pred),
        np.asarray(feats["a_mask"]),
        asym[tok],
        (np.asarray(feats["is_ligand"]) < 1)[tok],
    )
    metrics["ranking_confidence"] = (
        0.8 * metrics["iptm"] + 0.2 * metrics["ptm"] - metrics["has_clash"]
    )
    return metrics


def pose_diagnostics(ligand_pos: np.ndarray, mol) -> Dict[str, float]:
    """Denoised-geometry diagnostics: bond-length and angle deviations of a
    ligand pose vs ideal values (training-era logging —
    loss_module2.py:684-704 lineage)."""
    from physdock_tpu_torch.data.embed import ideal_bond_length

    z = mol.atomic_numbers
    bond_err = []
    for i, j, o in mol.bonds:
        d = float(np.linalg.norm(ligand_pos[i] - ligand_pos[j]))
        bond_err.append(abs(d - ideal_bond_length(int(z[i]), int(z[j]), o)))
    angle_err = []
    adj = mol.adjacency
    ref = mol.coords
    for c in range(mol.num_atoms):
        nbrs = adj[c]
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                i, j = nbrs[a], nbrs[b]

                def ang(x):
                    v1 = x[i] - x[c]
                    v2 = x[j] - x[c]
                    cos = np.dot(v1, v2) / (
                        np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9
                    )
                    return np.degrees(np.arccos(np.clip(cos, -1, 1)))

                if ref is not None:
                    angle_err.append(abs(ang(ligand_pos) - ang(ref)))
    return {
        "bond_err_mean": float(np.mean(bond_err)) if bond_err else 0.0,
        "bond_err_max": float(np.max(bond_err)) if bond_err else 0.0,
        "angle_err_mean": float(np.mean(angle_err)) if angle_err else 0.0,
    }
