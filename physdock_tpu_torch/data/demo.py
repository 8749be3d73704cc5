"""Self-contained demo system synthesis (zero external assets).

The reference ships prepared demo data (demo/redocking, demo/screening,
demo/system_preparation) that its READMEs drive the CLIs with.  This
module replaces that *data dependency* with a generator: a synthetic
two-helix receptor built from ideal backbone geometry (NeRF atom
placement at standard alpha-helical phi/psi) plus a drug-like ligand
parsed and 3D-embedded from SMILES by the in-house chem stack
(data/smiles.py, data/embed.py), placed in the inter-helix groove.  The
complex goes through the SAME preparation path real inputs take
(PDB + SDF text -> data/system.generate_system -> system pkl + fastas),
so every demo, test, and CLI can run with no files outside the repo.

Reference parity: demos there start from prepared pkls
(e.g. demo/redocking/Posebusters_subset/*.pkl.gz); here
`make_demo_complex` manufactures an equivalent pkl from nothing.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.data.constants import restypes as rc
from physdock_tpu_torch.data.mol import write_sdf
from physdock_tpu_torch.data.smiles import mol_from_smiles
from physdock_tpu_torch.data.system import generate_system

# Ideal backbone internals (Engh & Huber values, as used by every
# structure-building stack; degrees / angstroms).
_B_N_CA, _B_CA_C, _B_C_N = 1.458, 1.525, 1.329
_B_C_O, _B_CA_CB = 1.231, 1.530
_A_N_CA_C, _A_CA_C_N, _A_C_N_CA = 111.2, 116.2, 121.7
_A_CA_C_O, _A_N_CA_CB = 120.8, 110.5
_HELIX_PHI, _HELIX_PSI, _OMEGA = -57.0, -47.0, 180.0

DEMO_SEQUENCE = "ADELKVFNSIRTMQHWYEKLAVDFNSIR"  # 28 aa, varied types
DEMO_SMILES = "CC(=O)Nc1ccc(O)cc1"  # paracetamol: amide + aromatic ring


def _place(a: np.ndarray, b: np.ndarray, c: np.ndarray,
           length: float, angle_deg: float, dihedral_deg: float) -> np.ndarray:
    """NeRF: position d bonded to c with |cd|=length, angle(b,c,d) and
    dihedral(a,b,c,d) as given."""
    ang = np.deg2rad(angle_deg)
    dih = np.deg2rad(dihedral_deg)
    bc = c - b
    bc = bc / np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n = n / np.linalg.norm(n)
    m = np.cross(n, bc)
    d = np.array([
        -length * np.cos(ang),
        length * np.sin(ang) * np.cos(dih),
        length * np.sin(ang) * np.sin(dih),
    ])
    return c + d[0] * bc + d[1] * m + d[2] * n


def build_helix(sequence: str) -> List[Dict[str, np.ndarray]]:
    """Ideal alpha helix: per-residue {N, CA, C, O[, CB]} coordinates."""
    n_res = len(sequence)
    N = [np.array([0.0, 0.0, 0.0])]
    CA = [np.array([_B_N_CA, 0.0, 0.0])]
    # angle(N, CA, C) = 111.2 deg in the xy-plane
    CA_to_C = np.array([-np.cos(np.deg2rad(_A_N_CA_C)),
                        np.sin(np.deg2rad(_A_N_CA_C)), 0.0])
    C = [CA[0] + _B_CA_C * CA_to_C]
    for i in range(1, n_res):
        N.append(_place(N[i - 1], CA[i - 1], C[i - 1], _B_C_N, _A_CA_C_N,
                        _HELIX_PSI))
        CA.append(_place(CA[i - 1], C[i - 1], N[i], _B_N_CA, _A_C_N_CA,
                         _OMEGA))
        C.append(_place(C[i - 1], N[i], CA[i], _B_CA_C, _A_N_CA_C,
                        _HELIX_PHI))
    residues: List[Dict[str, np.ndarray]] = []
    for i in range(n_res):
        psi = _HELIX_PSI  # last residue: keep the helical value
        atoms = {
            "N": N[i], "CA": CA[i], "C": C[i],
            "O": _place(N[i], CA[i], C[i], _B_C_O, _A_CA_C_O, psi + 180.0),
        }
        if sequence[i] != "G":
            # L-configuration: improper dihedral(C, N, CA, CB) ~ -122.6 deg
            atoms["CB"] = _place(C[i], N[i], CA[i], _B_CA_CB, _A_N_CA_CB,
                                 -122.6)
        residues.append(atoms)
    return residues


_ONE_TO_THREE = {v.strip(): k for k, v in
                 [(ccd, rc.three_to_one(ccd)) for ccd in rc.AA_ATOMS]
                 if v != "X"}


def _pdb_lines(residues, sequence, chain_id, first_serial=1,
               first_resnum=1) -> Tuple[List[str], int]:
    lines = []
    serial = first_serial
    for i, atoms in enumerate(residues):
        res3 = _ONE_TO_THREE.get(sequence[i], "UNK")
        for name, xyz in atoms.items():
            lines.append(
                f"ATOM  {serial:>5}  {name:<3} {res3:>3} {chain_id}"
                f"{first_resnum + i:>4}    "
                f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
                f"  1.00  0.00          {name[0]:>2}"
            )
            serial += 1
    return lines, serial


def _stack_atoms(residues) -> np.ndarray:
    return np.array([xyz for r in residues for xyz in r.values()], np.float32)


def make_demo_receptor(
    sequence: str = DEMO_SEQUENCE, separation: float = 13.0
) -> Tuple[str, np.ndarray, np.ndarray]:
    """Two antiparallel ideal helices (chains A and B) forming a groove.

    Returns (pdb_text, groove_frame, receptor_xyz) where groove_frame rows
    are the groove centre, the helix-axis direction and the groove normal.
    """
    helix = build_helix(sequence)
    ca = np.array([r["CA"] for r in helix])
    axis = ca[-1] - ca[0]
    axis = axis / np.linalg.norm(axis)
    mid = ca.mean(axis=0)
    p = np.cross(axis, np.array([0.0, 0.0, 1.0]))
    if np.linalg.norm(p) < 1e-3:
        p = np.cross(axis, np.array([0.0, 1.0, 0.0]))
    p = p / np.linalg.norm(p)
    q = np.cross(axis, p)

    # chain B: rotate 180 deg about p through the midpoint (antiparallel),
    # then offset by `separation` along q
    cth, sth = -1.0, 0.0  # cos/sin(pi)
    pp = np.outer(p, p)
    K = np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
    R = cth * np.eye(3) + sth * K + (1 - cth) * pp
    helix_b = [
        {k: (R @ (v - mid)) + mid + separation * q for k, v in r.items()}
        for r in helix
    ]

    lines = ["HEADER    SYNTHETIC DEMO COMPLEX (physdock_tpu)"]
    la, serial = _pdb_lines(helix, sequence, "A")
    lines += la + ["TER"]
    lb, _ = _pdb_lines(helix_b, sequence, "B", first_serial=serial)
    lines += lb + ["TER", "END"]
    groove_frame = np.stack([mid + 0.5 * separation * q, axis, q])
    receptor_xyz = np.concatenate([_stack_atoms(helix), _stack_atoms(helix_b)])
    return "\n".join(lines) + "\n", groove_frame, receptor_xyz


def place_ligand(lig_coords: np.ndarray, receptor_xyz: np.ndarray,
                 groove_frame: np.ndarray, min_clearance: float = 3.0
                 ) -> np.ndarray:
    """Centre the ligand in the groove at the pose maximising its minimum
    distance to receptor atoms over a small grid along the groove axes."""
    centre, axis, q = groove_frame
    lig = lig_coords - lig_coords.mean(axis=0)
    best, best_d = None, -np.inf
    for t in np.linspace(-6.0, 6.0, 13):
        for u in np.linspace(-2.0, 2.0, 5):
            cand = lig + centre + t * axis + u * q
            d = np.min(np.linalg.norm(
                cand[:, None, :] - receptor_xyz[None, :, :], axis=-1))
            if d > best_d:
                best, best_d = cand, d
    if best_d < min_clearance:
        raise ValueError(
            f"no clash-free ligand placement (best clearance {best_d:.2f} A)")
    return np.asarray(best, np.float32)


def make_demo_complex(output_dir: str, name: str = "DEMO",
                      sequence: str = DEMO_SEQUENCE,
                      smiles: str = DEMO_SMILES, seed: int = 0,
                      ligand_sdf: Optional[str] = None) -> str:
    """Synthesize receptor + ligand, write PDB/SDF, and prepare the system
    pkl through the standard generate_system path.  Returns the pkl path."""
    os.makedirs(output_dir, exist_ok=True)
    pdb_text, groove, rec_xyz = make_demo_receptor(sequence)
    pdb_path = os.path.join(output_dir, f"{name}_receptor.pdb")
    with open(pdb_path, "w") as f:
        f.write(pdb_text)

    if ligand_sdf is None:
        mol = mol_from_smiles(smiles, embed=True, seed=seed)
        mol.coords = place_ligand(mol.coords, rec_xyz, groove)
        ligand_sdf = os.path.join(output_dir, f"{name}_ligand.sdf")
        with open(ligand_sdf, "w") as f:
            f.write(write_sdf(mol, name=name))

    return generate_system(pdb_path, ligand_sdf, output_dir=output_dir,
                           name=name)
