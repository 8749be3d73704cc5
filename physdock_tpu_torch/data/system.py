"""System preparation: receptor PDB + ligand SDF -> system pkl + fastas.

Re-implementation of reference PhysDock/data/generate_system.py:16-147
without BioPython/RDKit.  Extension over the reference schema: the ligand
chain carries its CCD metadata inline ("ligand_meta"), so no external
ccd_id_meta_data blob is needed downstream.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from physdock_tpu_torch.data.ccd import CCDLibrary, ligand_entry
from physdock_tpu_torch.data.constants import restypes as rc
from physdock_tpu_torch.data.mol import read_sdf
from physdock_tpu_torch.data.parsers import parse_pdb
from physdock_tpu_torch.utils.io import dump_pkl, dump_txt, protein_msa_key


def generate_system(
    receptor_pdb: str,
    ligand_sdf: Optional[str] = None,
    output_dir: str = ".",
    name: Optional[str] = None,
    ccd: Optional[CCDLibrary] = None,
) -> str:
    """Build `<name>_<chains>.pkl.gz` + md5-named fastas.

    Receptor residues use the standard-residue atom order (N/CA/C/O/CB...,
    generate_system.py:64-98 with order from CCD metadata); unknown residues
    become UNK with only backbone atoms kept.  The ligand becomes digit
    chain "1" (generate_system.py:106-127).
    """
    ccd = ccd or CCDLibrary()
    chains = parse_pdb(receptor_pdb)
    system: Dict[str, Dict] = {}
    fasta: Dict[str, str] = {}

    for chain_id, chain in chains.items():
        positions: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        ccds: List[str] = []
        for res in chain.residues:
            if res.hetero and res.name not in rc.AA_ATOMS:
                continue  # non-polymer het groups are not the receptor
            ccd_code = res.name if res.name in rc.AA_ATOMS else "UNK"
            names = ccd[ccd_code]["ref_atom_name_chars"]
            pos = np.zeros((len(names), 3), np.float32)
            mask = np.zeros(len(names), np.int8)
            for k, nm in enumerate(names):
                if nm in res.atoms:
                    pos[k] = res.atoms[nm]
                    mask[k] = 1
            positions.append(pos)
            masks.append(mask)
            ccds.append(ccd_code)
        if not ccds:
            continue
        n_res = len(ccds)
        system[chain_id] = {
            "all_atom_positions": positions,
            "all_atom_mask": masks,
            "ccds": ccds,
            # PLIP interaction channels default to zero
            # (generate_system.py:100-104; real values come from PLIP runs)
            **{
                ch: np.zeros(n_res, np.int8)
                for ch in (
                    "salt bridges",
                    "pi-cation interactions",
                    "hydrophobic interactions",
                    "pi-stacking",
                    "hydrogen bonds",
                    "metal complexes",
                )
            },
        }
        seq = "".join(rc.three_to_one(c) for c in ccds)
        fasta[protein_msa_key(seq)] = seq

    if ligand_sdf is not None:
        mol = read_sdf(ligand_sdf)
        entry = ligand_entry(mol, ref_pos=None)
        n = mol.num_atoms
        system["1"] = {
            "all_atom_positions": [np.asarray(mol.coords, np.float32)],
            "all_atom_mask": [np.ones(n, np.int8)],
            "ccds": ["LIG"],
            "ligand_meta": entry,
            **{
                ch: np.zeros(1, np.int8)
                for ch in (
                    "salt bridges",
                    "pi-cation interactions",
                    "hydrophobic interactions",
                    "pi-stacking",
                    "hydrogen bonds",
                    "metal complexes",
                )
            },
        }

    if name is None:
        name = os.path.basename(receptor_pdb).rsplit(".", 1)[0]
    chain_tag = "_".join(list(system.keys()))
    out_path = os.path.join(output_dir, f"{name}_{chain_tag}.pkl.gz")
    os.makedirs(output_dir, exist_ok=True)
    dump_pkl(system, out_path)
    for md5, seq in fasta.items():
        dump_txt([f">{md5}", seq], os.path.join(output_dir, f"{md5}.fasta"))
    return out_path
