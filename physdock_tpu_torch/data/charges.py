"""Partial charges for relaxation electrostatics.

The reference relaxes poses with OpenMM under amber14 + GBN2
(PhysDock/data/relaxation.py:243-259), which means every atom carries a
typed partial charge and the minimization feels electrostatics.  The
in-house restraint-field relax (infer/relax.py) replaces OpenMM; this
module supplies the charges:

- ``gasteiger_charges``: PEOE (Gasteiger-Marsili 1980) partial charges
  for ligands, computed on the heavy-atom ``Molecule`` graph by expanding
  implicit hydrogens into virtual nodes, iterating the standard
  electronegativity-equalization recurrence, then folding each H charge
  back onto its heavy atom (united-atom charges — the same convention the
  docking relax uses for sterics).
- ``receptor_partial_charges``: coarse amber-inspired united-atom charges
  for receptor atoms from (residue, atom-name) tables, normalized so each
  residue sums exactly to its formal charge (the monopole dominates at
  interface distances, so per-residue neutrality/net-charge correctness
  matters more than per-atom precision).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from physdock_tpu_torch.data.mol import Molecule

# Gasteiger-Marsili (a, b, c) electronegativity parameters per
# (element, hybridization); chi(q) = a + b q + c q^2.  Hybridization key:
# 1 = sp, 2 = sp2/aromatic, 3 = sp3.  The cation denominator chi(+1) is
# a + b + c except hydrogen's conventional 20.02.
_PEOE = {
    (1, 3): (7.17, 6.24, -0.56),
    (6, 3): (7.98, 9.18, 1.88),
    (6, 2): (8.79, 9.32, 1.51),
    (6, 1): (10.39, 9.45, 0.73),
    (7, 3): (11.54, 10.82, 1.36),
    (7, 2): (12.87, 11.15, 0.85),
    (7, 1): (15.68, 11.70, -0.27),
    (8, 3): (14.18, 12.92, 1.39),
    (8, 2): (17.07, 13.79, 0.47),
    (9, 3): (14.66, 13.85, 2.31),
    (17, 3): (11.00, 9.69, 1.35),
    (35, 3): (10.08, 8.47, 1.16),
    (53, 3): (9.90, 7.96, 0.96),
    (16, 3): (10.14, 9.13, 1.38),
    (16, 2): (10.14, 9.13, 1.38),
    (15, 3): (8.90, 8.24, 0.96),
}
_DEFAULT_ABC = (9.0, 9.0, 1.0)  # metals/exotics: carbon-like fallback


def _hybridization(mol: Molecule) -> np.ndarray:
    """1/2/3 per heavy atom from bond orders + aromaticity."""
    arom = mol.aromatic_atoms().astype(bool)  # int8 ints would fancy-index
    n = mol.num_atoms
    n_double = np.zeros(n, np.int32)
    has_triple = np.zeros(n, bool)
    for i, j, o in mol.bonds:
        if o == 3.0:
            has_triple[i] = has_triple[j] = True
        elif o == 2.0:
            n_double[i] += 1
            n_double[j] += 1
    hyb = np.full(n, 3, np.int32)
    hyb[(n_double >= 1) | arom] = 2
    hyb[has_triple | (n_double >= 2)] = 1
    return hyb


def gasteiger_charges(mol: Molecule, n_iter: int = 8) -> np.ndarray:
    """United-atom PEOE partial charges: [num_heavy_atoms] float32,
    summing exactly to the molecule's total formal charge.

    Implicit hydrogens (data/protomers.py total_h_counts) participate as
    virtual nodes and their converged charges are folded back onto the
    bonded heavy atom.
    """
    from physdock_tpu_torch.data.protomers import total_h_counts

    nh = total_h_counts(mol)
    n_heavy = mol.num_atoms
    z_list = [int(z) for z in mol.atomic_numbers]
    parent: List[int] = []
    bonds = [(int(i), int(j)) for i, j, _ in mol.bonds]
    for a in range(n_heavy):
        for _ in range(int(nh[a])):
            z_list.append(1)
            bonds.append((a, n_heavy + len(parent)))
            parent.append(a)
    n = len(z_list)

    hyb_heavy = _hybridization(mol)
    abc = np.empty((n, 3))
    for a in range(n):
        z = z_list[a]
        h = int(hyb_heavy[a]) if a < n_heavy else 3
        abc[a] = _PEOE.get((z, h)) or _PEOE.get((z, 3)) or _DEFAULT_ABC
    chi_plus = abc.sum(axis=1)
    chi_plus[np.array(z_list) == 1] = 20.02

    q = np.zeros(n)
    q[:n_heavy] = mol.charges.astype(np.float64)
    damp = 1.0
    for _ in range(n_iter):
        damp *= 0.5
        chi = abc[:, 0] + abc[:, 1] * q + abc[:, 2] * q * q
        dq = np.zeros(n)
        for i, j in bonds:
            if chi[j] > chi[i]:
                t = (chi[j] - chi[i]) / chi_plus[i] * damp
                dq[i] += t
                dq[j] -= t
            else:
                t = (chi[i] - chi[j]) / chi_plus[j] * damp
                dq[i] -= t
                dq[j] += t
        q += dq

    out = q[:n_heavy].copy()
    for h_idx, p in enumerate(parent):
        out[p] += q[n_heavy + h_idx]
    return out.astype(np.float32)


# ---------------------------------------------------------------- receptor

# key polar/charged atoms per residue (united-atom, H folded); everything
# else defaults to the backbone table or 0, then the per-residue residual
# is spread uniformly so the residue's net charge is exact
_BACKBONE = {"N": -0.30, "CA": 0.05, "C": 0.55, "O": -0.55, "OXT": -0.75}
_SIDECHAIN: Dict[str, Dict[str, float]] = {
    "ASP": {"CG": 0.60, "OD1": -0.75, "OD2": -0.75},
    "GLU": {"CD": 0.60, "OE1": -0.75, "OE2": -0.75},
    "LYS": {"NZ": 0.65, "CE": 0.20},
    "ARG": {"CZ": 0.65, "NH1": 0.25, "NH2": 0.25, "NE": 0.05},
    "HIS": {"ND1": -0.20, "NE2": -0.20, "CE1": 0.25},
    "SER": {"OG": -0.25},
    "THR": {"OG1": -0.25},
    "TYR": {"OH": -0.25},
    "CYS": {"SG": -0.20},
    "MET": {"SD": -0.10},
    "ASN": {"OD1": -0.55, "ND2": -0.10, "CG": 0.55},
    "GLN": {"OE1": -0.55, "NE2": -0.10, "CD": 0.55},
    "TRP": {"NE1": -0.10},
}
_RES_NET = {"ASP": -1.0, "GLU": -1.0, "LYS": 1.0, "ARG": 1.0}
# nucleic-acid phosphate backbone (RNA path)
_NA_ATOMS = {"P": 0.8, "OP1": -0.75, "OP2": -0.75, "O5'": -0.3, "O3'": -0.3}


def receptor_partial_charges(
    res_names: Sequence[str],
    atom_names: Sequence[str],
    residue_ids: Sequence[int],
) -> np.ndarray:
    """Per-atom united-atom charges for polymer atoms.

    `res_names`/`atom_names`/`residue_ids` are flat per-atom arrays (the
    featurizer meta expanded over chunk_sizes); each residue's charges are
    shifted uniformly so its sum equals the residue's formal net charge.
    """
    n = len(atom_names)
    q = np.zeros(n)
    for i in range(n):
        res = str(res_names[i]).strip().upper()
        nm = str(atom_names[i]).strip().upper()
        sc = _SIDECHAIN.get(res, {})
        if nm in sc:
            q[i] = sc[nm]
        elif nm in _BACKBONE:
            q[i] = _BACKBONE[nm]
        elif nm in _NA_ATOMS:
            q[i] = _NA_ATOMS[nm]
    # exact per-residue monopole
    rid = np.asarray(residue_ids)
    for r in np.unique(rid):
        sel = rid == r
        res = str(np.asarray(res_names)[sel][0]).strip().upper()
        target = _RES_NET.get(res, 0.0)
        q[sel] += (target - q[sel].sum()) / max(int(sel.sum()), 1)
    return q.astype(np.float32)


def receptor_charges_from_meta(meta: Dict, rec_sel: np.ndarray) -> np.ndarray:
    """Typed charges for the receptor subset `rec_sel` of the flat atom
    array, from featurizer meta (ccds per token + chunk_sizes + names)."""
    ccds = meta.get("ccds")
    chunks = meta.get("chunk_sizes")
    names = meta.get("atom_names")
    if ccds is None or chunks is None or names is None:
        return np.zeros(len(rec_sel), np.float32)
    res_flat = np.repeat(np.asarray(ccds, object), np.asarray(chunks))
    rid_flat = np.repeat(np.arange(len(np.asarray(chunks))), np.asarray(chunks))
    if len(res_flat) != len(names):  # inconsistent meta: stay neutral
        return np.zeros(len(rec_sel), np.float32)
    return receptor_partial_charges(
        [res_flat[i] for i in rec_sel],
        [names[i] for i in rec_sel],
        rid_flat[rec_sel],
    )
