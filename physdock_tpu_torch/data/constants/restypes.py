"""Standard residue (CCD) tables.

Equivalent of reference data/constants/restype_constants.py: the 31 standard
CCDs (20 AA + UNK + 5 RNA + 5 DNA) + GAP ordering used for restype/MSA
one-hots, predicates, special-atom names, and per-residue heavy-atom
composition (names in PDB CCD order: N/CA/C/O/CB first, trailing OXT, no H)
plus intra-residue bond graphs (used to regenerate the CCD metadata the
reference ships as a binary blob — see data/ccd.py).
"""

from __future__ import annotations

import numpy as np

# ----------------------------- CCD orderings --------------------------------

STANDARD_PROTEIN = [
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL", "UNK",
]
STANDARD_RNA = ["A  ", "G  ", "C  ", "U  ", "N  "]
STANDARD_DNA = ["DA ", "DG ", "DC ", "DT ", "DN "]
STANDARD_NUCLEIC = STANDARD_RNA + STANDARD_DNA
GAP = "GAP"
STANDARD_CCDS = STANDARD_PROTEIN + STANDARD_NUCLEIC + [GAP]  # 32 classes
CCD_TO_ORDER = {ccd: i for i, ccd in enumerate(STANDARD_CCDS)}

UNK_CCDS = {"UNK", "N  ", "DN ", "GAP", "UNL"}


def is_standard(ccd: str) -> bool:
    return ccd in CCD_TO_ORDER


def is_unk(ccd: str) -> bool:
    return ccd in UNK_CCDS


def is_protein(ccd: str) -> bool:
    return ccd in STANDARD_PROTEIN and not is_unk(ccd)


def is_rna(ccd: str) -> bool:
    return ccd in STANDARD_RNA and not is_unk(ccd)


def is_dna(ccd: str) -> bool:
    return ccd in STANDARD_DNA and not is_unk(ccd)


def restype_order(ccd: str) -> int:
    """Index into the 32-class restype/MSA alphabet; unknowns -> UNK (20)."""
    return CCD_TO_ORDER.get(ccd, 20)


AA_3TO1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
    "UNK": "X",
}
AA_1TO3 = {v: k for k, v in AA_3TO1.items()}

# common modified residues -> parent 1-letter (subset of the PDBData
# extended table; extend as needed)
AA_3TO1_EXTENDED = {
    **AA_3TO1,
    "MSE": "M", "SEC": "C", "PYL": "K", "SEP": "S", "TPO": "T",
    "PTR": "Y", "CSO": "C", "HYP": "P", "MLY": "K", "M3L": "K",
    "CME": "C", "KCX": "K", "LLP": "K", "CSD": "C", "OCS": "C",
    "PCA": "E", "DAL": "A", "DAR": "R", "DSG": "N", "DSP": "D",
    "DCY": "C", "DGL": "E", "DGN": "Q", "DHI": "H", "DIL": "I",
    "DLE": "L", "DLY": "K", "MED": "M", "DPN": "F", "DPR": "P",
    "DSN": "S", "DTH": "T", "DTR": "W", "DTY": "Y", "DVA": "V",
}


def three_to_one(ccd: str) -> str:
    return AA_3TO1_EXTENDED.get(ccd.strip(), "X")


# special atoms per token (restype_constants.py:73-98)
TOKEN_CENTRE_ATOM = {
    **{r: "CA" for r in STANDARD_PROTEIN},
    **{r: "C1'" for r in STANDARD_NUCLEIC},
}
PURINES = {"A  ", "G  ", "DA ", "DG "}
PYRIMIDINES = {"C  ", "U  ", "DC ", "DT "}
TOKEN_PSEUDO_BETA_ATOM = {
    **{r: "CB" for r in STANDARD_PROTEIN},
    **{r: "C4" for r in PURINES},
    **{r: "C2" for r in PYRIMIDINES},
    "GLY": "CA",
}
FRAME_ATOMS = {
    **{r: ("N", "CA", "C") for r in STANDARD_PROTEIN},
    **{r: ("C1'", "C3'", "C4'") for r in STANDARD_NUCLEIC},
}

# --------------------- heavy-atom composition + bonds -----------------------
# Atom order: N CA C O CB ... OXT (PDB CCD order, no H) — index 1 must be CA
# and index 4 CB, which the featurizer's conformer-exists checks rely on
# (feature_loader.py:260-265).

AA_ATOMS = {
    "ALA": ["N", "CA", "C", "O", "CB"],
    "ARG": ["N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"],
    "ASP": ["N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"],
    "CYS": ["N", "CA", "C", "O", "CB", "SG"],
    "GLN": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"],
    "GLU": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"],
    "GLY": ["N", "CA", "C", "O"],
    "HIS": ["N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"],
    "LEU": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"],
    "LYS": ["N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"],
    "MET": ["N", "CA", "C", "O", "CB", "CG", "SD", "CE"],
    "PHE": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["N", "CA", "C", "O", "CB", "CG", "CD"],
    "SER": ["N", "CA", "C", "O", "CB", "OG"],
    "THR": ["N", "CA", "C", "O", "CB", "OG1", "CG2"],
    "TRP": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2",
            "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
    "VAL": ["N", "CA", "C", "O", "CB", "CG1", "CG2"],
    "UNK": ["N", "CA", "C", "O", "CB"],
}

for _atoms in AA_ATOMS.values():
    _atoms.append("OXT")

# (i_name, j_name, order) — order: 1 single, 2 double, 1.5 aromatic
AA_BONDS = {
    "ALA": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1)],
    "ARG": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD", 1), ("CD", "NE", 1), ("NE", "CZ", 1),
            ("CZ", "NH1", 1), ("CZ", "NH2", 2)],
    "ASN": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "OD1", 2), ("CG", "ND2", 1)],
    "ASP": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "OD1", 2), ("CG", "OD2", 1)],
    "CYS": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "SG", 1)],
    "GLN": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD", 1), ("CD", "OE1", 2), ("CD", "NE2", 1)],
    "GLU": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD", 1), ("CD", "OE1", 2), ("CD", "OE2", 1)],
    "GLY": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2)],
    "HIS": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "ND1", 1.5), ("CG", "CD2", 1.5),
            ("ND1", "CE1", 1.5), ("CD2", "NE2", 1.5), ("CE1", "NE2", 1.5)],
    "ILE": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG1", 1), ("CB", "CG2", 1), ("CG1", "CD1", 1)],
    "LEU": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD1", 1), ("CG", "CD2", 1)],
    "LYS": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD", 1), ("CD", "CE", 1), ("CE", "NZ", 1)],
    "MET": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "SD", 1), ("SD", "CE", 1)],
    "PHE": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD1", 1.5), ("CG", "CD2", 1.5),
            ("CD1", "CE1", 1.5), ("CD2", "CE2", 1.5), ("CE1", "CZ", 1.5),
            ("CE2", "CZ", 1.5)],
    "PRO": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD", 1), ("CD", "N", 1)],
    "SER": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "OG", 1)],
    "THR": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "OG1", 1), ("CB", "CG2", 1)],
    "TRP": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD1", 1.5), ("CG", "CD2", 1.5),
            ("CD1", "NE1", 1.5), ("NE1", "CE2", 1.5), ("CD2", "CE2", 1.5),
            ("CD2", "CE3", 1.5), ("CE3", "CZ3", 1.5), ("CZ3", "CH2", 1.5),
            ("CH2", "CZ2", 1.5), ("CZ2", "CE2", 1.5)],
    "TYR": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG", 1), ("CG", "CD1", 1.5), ("CG", "CD2", 1.5),
            ("CD1", "CE1", 1.5), ("CD2", "CE2", 1.5), ("CE1", "CZ", 1.5),
            ("CE2", "CZ", 1.5), ("CZ", "OH", 1)],
    "VAL": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1),
            ("CB", "CG1", 1), ("CB", "CG2", 1)],
    "UNK": [("N", "CA", 1), ("CA", "C", 1), ("C", "O", 2), ("CA", "CB", 1)],
}

for _bonds in AA_BONDS.values():
    _bonds.append(("C", "OXT", 1))

# heavy-atom counts INCLUDING the trailing OXT (PDB CCD order, matching the
# reference blob's per-residue arrays observed in the demo systems)
EXPECTED_ATOM_COUNTS = {
    "ALA": 6, "ARG": 12, "ASN": 9, "ASP": 9, "CYS": 7, "GLN": 10, "GLU": 10,
    "GLY": 5, "HIS": 11, "ILE": 9, "LEU": 9, "LYS": 10, "MET": 9, "PHE": 12,
    "PRO": 8, "SER": 7, "THR": 8, "TRP": 15, "TYR": 13, "VAL": 8,
}

# one-hot basis matrices (restype_constants.py:102-107)
eye_128 = np.eye(128, dtype=np.float32)
eye_32 = np.eye(32, dtype=np.float32)
eye_9 = np.eye(9, dtype=np.float32)
eye_7 = np.eye(7, dtype=np.float32)
eye_5 = np.eye(5, dtype=np.float32)
eye_3 = np.eye(3, dtype=np.float32)
