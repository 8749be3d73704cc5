"""PDB parsing (BioPython-free).

Minimal structural parser for receptor PDB files: per-chain, per-residue
heavy-atom coordinates keyed by atom name.  Replaces the BioPython usage in
reference data/generate_system.py:64-98.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Residue:
    name: str  # 3-letter CCD
    number: int
    insertion: str
    atoms: Dict[str, np.ndarray]  # atom name -> xyz
    elements: Dict[str, str]
    hetero: bool


@dataclasses.dataclass
class Chain:
    chain_id: str
    residues: List[Residue]


def parse_pdb(path_or_text: str, model_index: int = 0) -> Dict[str, Chain]:
    """Parse ATOM/HETATM records of one model into chains (waters skipped)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    chains: Dict[str, Chain] = {}
    current_model = 0
    seen_model_record = False
    for line in text.splitlines():
        rec = line[:6].strip()
        if rec == "MODEL":
            if seen_model_record:
                current_model += 1
            seen_model_record = True
            continue
        if rec == "ENDMDL":
            if current_model >= model_index:
                break
            continue
        if rec not in ("ATOM", "HETATM"):
            continue
        if seen_model_record and current_model != model_index:
            continue
        altloc = line[16]
        if altloc not in (" ", "A"):
            continue
        res_name = line[17:20].strip()
        if res_name == "HOH":
            continue
        atom_name = line[12:16].strip()
        chain_id = line[21].strip() or "A"
        res_num = int(line[22:26])
        icode = line[26].strip()
        xyz = np.array(
            [float(line[30:38]), float(line[38:46]), float(line[46:54])], np.float32
        )
        element = line[76:78].strip() if len(line) >= 78 else ""
        if not element:
            element = atom_name.strip(" 0123456789")[:1]
        if element.upper() == "H" or element.upper() == "D":
            continue

        chain = chains.setdefault(chain_id, Chain(chain_id, []))
        if (
            not chain.residues
            or chain.residues[-1].number != res_num
            or chain.residues[-1].insertion != icode
            or chain.residues[-1].name != res_name
        ):
            chain.residues.append(
                Residue(res_name, res_num, icode, {}, {}, rec == "HETATM")
            )
        res = chain.residues[-1]
        if atom_name not in res.atoms:
            res.atoms[atom_name] = xyz
            res.elements[atom_name] = element
    return chains


def chain_sequence(chain: Chain) -> str:
    from physdock_tpu_torch.data.constants.restypes import three_to_one

    return "".join(three_to_one(r.name) for r in chain.residues)
