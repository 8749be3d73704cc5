"""Structure output writers (PDB / SDF).

Equivalent of FeatureLoader.write_pdb / write_pdb_block
(reference: feature_loader.py:1175-1282) driven by the featurizer's meta
dict, plus ligand SDF output via data/mol.write_sdf.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

PDB_CHAIN_IDS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"


def pdb_block(
    x_pred: np.ndarray,
    meta: Dict,
    receptor_only: bool = False,
    ligand_only: bool = False,
    b_factors: Optional[np.ndarray] = None,
) -> str:
    """Serialize predicted coordinates [A, 3] to a single-model PDB block."""
    lines = []
    atom_names = meta["atom_names"]
    elements = meta["atom_elements"]
    chunk_sizes = np.asarray(meta["chunk_sizes"]).astype(int)
    residue_index = np.asarray(meta["residue_index"]).astype(int)
    asym_id = np.asarray(meta["asym_id"]).astype(int)
    ccds = meta["ccds"]
    chain_class = meta["chain_class"]

    atom_i = 0
    n_atoms = len(atom_names)
    for conf_id, (ccd, sz) in enumerate(zip(ccds, chunk_sizes)):
        het = chain_class[conf_id] == "ligand"
        record = "HETATM" if het else "ATOM"
        chain_tag = PDB_CHAIN_IDS[asym_id[conf_id] % len(PDB_CHAIN_IDS)]
        for _ in range(int(sz)):
            if atom_i >= n_atoms or atom_i >= len(x_pred):
                break
            keep = (not receptor_only and not ligand_only) or (
                receptor_only and not het
            ) or (ligand_only and het)
            if keep:
                name = atom_names[atom_i].strip()
                name_f = name if len(name) == 4 else f" {name:<3}"
                # PDB fixed columns cannot represent |coord| >= 10000
                x, y, z = np.clip(np.asarray(x_pred[atom_i], float), -999.999, 9999.999)
                b = float(b_factors[atom_i]) if b_factors is not None else 70.0
                lines.append(
                    f"{record:<6}{atom_i + 1:>5} {name_f:<4} "
                    f"{ccd.split()[0][-3:]:>3} {chain_tag}"
                    f"{residue_index[conf_id] + 1:>4}    "
                    f"{x:>8.3f}{y:>8.3f}{z:>8.3f}"
                    f"{1.0:>6.2f}{b:>6.2f}          "
                    f"{elements[atom_i]:>2}"
                )
            atom_i += 1
    body = "\n".join(lines)
    return f"MODEL     1\n{body}\nTER\nENDMDL\nEND"


def write_pdb(x_pred, meta, path, **kw) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(pdb_block(x_pred, meta, **kw) + "\n")


def write_ligand_sdf(x_pred, meta, path, name: Optional[str] = None) -> None:
    """Write the ligand atoms of a full-complex prediction as SDF."""
    from physdock_tpu_torch.data.mol import write_sdf

    mol = meta.get("ref_mol")
    lig_idx = np.asarray(meta["ligand_atom_idx"])
    coords = np.asarray(x_pred)[lig_idx]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if mol is not None and mol.num_atoms == len(coords):
        with open(path, "w") as f:
            f.write(write_sdf(mol, coords=coords, name=name))
    else:
        # element-only fallback: no bonds known
        from physdock_tpu_torch.data.mol import Molecule

        el = [meta["atom_elements"][i] for i in lig_idx]
        from physdock_tpu_torch.data.constants.periodic_table import atomic_number

        m = Molecule(
            np.array([atomic_number(e) for e in el], np.int32),
            np.zeros(len(el), np.int32),
            [],
            coords,
            name or "ligand",
        )
        with open(path, "w") as f:
            f.write(write_sdf(m, name=name))
