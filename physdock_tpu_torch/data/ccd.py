"""CCD (chemical component dictionary) metadata.

The reference depends on a prebuilt `params/ccd_id_meta_data.pkl.gz` blob
(absent from its repo — .MISSING_LARGE_BLOBS) holding, per CCD code, the
reference-conformer features consumed by the featurizer
(feature_loader.py:138-176).  Here the metadata is *generated*:

  * standard residues: molecule graphs from data/constants/restypes.py,
    ideal coordinates from the in-house embedder (deterministic, cached);
  * arbitrary ligands: from an SDF Molecule or SMILES;
  * a loader for an external ccd_id_meta_data.pkl.gz when provided (same
    schema), so reference-prepared systems remain usable.

Entry schema (dict per CCD):
  ref_pos [n,3] f32, ref_charge [n], ref_element [n] (atomic_number-1),
  ref_is_aromatic/_degree/_hybridization/_implicit_valence/_chirality [n],
  ref_in_ring_of_3..8 [n], d_token/token_bonds/bond_type/bond_as_double/
  bond_in_ring/bond_is_conjugated/bond_is_aromatic [n,n],
  ref_atom_name_chars [n] str, ref_mol (Molecule | None).
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, Optional

import numpy as np

from physdock_tpu_torch.data.constants import restypes as rc
from physdock_tpu_torch.data.constants.periodic_table import SYMBOL_TO_NUMBER
from physdock_tpu_torch.data.mol import Molecule, conformer_features
from physdock_tpu_torch.utils.io import load_pkl


def residue_molecule(ccd: str) -> Molecule:
    """Build the heavy-atom Molecule of a standard amino acid."""
    names = rc.AA_ATOMS[ccd]
    index = {n: i for i, n in enumerate(names)}
    atomic = [SYMBOL_TO_NUMBER[n[0]] for n in names]
    bonds = [(index[a], index[b], o) for a, b, o in rc.AA_BONDS[ccd]]
    return Molecule(np.array(atomic), np.zeros(len(names), np.int32), bonds, None, ccd)


@functools.lru_cache(maxsize=64)
def standard_residue_entry(ccd: str) -> Dict:
    """CCD entry for a standard residue (ideal geometry embedded once)."""
    from physdock_tpu_torch.data.embed import embed_molecule

    mol = residue_molecule(ccd)
    # stable per-residue seed: python's str hash() is PYTHONHASHSEED-
    # randomized, which made the embedded ideal geometry (and thus
    # ref_pos/ref_feat of every protein atom) differ between processes —
    # breaking run-to-run reproducibility and the featurizer-worker
    # equality contract (tests/test_feat_worker.py)
    seed = int.from_bytes(hashlib.md5(ccd.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    mol.coords = embed_molecule(mol, rng, n_starts=3, iters=500)
    feats = conformer_features(mol)
    feats["ref_atom_name_chars"] = list(rc.AA_ATOMS[ccd])
    feats["ref_mol"] = mol
    return feats


def ligand_entry(mol: Molecule, ref_pos: Optional[np.ndarray] = None) -> Dict:
    """CCD entry for a ligand Molecule (coords must exist or be embedded).

    Atom names follow the reference's SMILES path: element symbol + index,
    left-justified to 4 chars (feature_loader.py:322-325)."""
    if ref_pos is None and mol.coords is None:
        from physdock_tpu_torch.data.embed import embed_molecule

        mol.coords = embed_molecule(mol)
    feats = conformer_features(mol, ref_pos)
    from physdock_tpu_torch.data.constants.periodic_table import element_symbol

    feats["ref_atom_name_chars"] = [
        f"{element_symbol(int(z)) + str(i):<4}"
        for i, z in enumerate(mol.atomic_numbers)
    ]
    feats["ref_mol"] = mol
    return feats


def infer_elements(pos: np.ndarray):
    """Heuristic heavy-atom element recovery from geometry (last resort).

    Reference-prepared system pkls carry only a CCD code + coordinates for
    the ligand; the reference resolves chemistry through its (missing)
    ccd_id_meta_data blob (reference: generate_system.py:29-38,
    .MISSING_LARGE_BLOBS:2).  With no offline CCD dictionary, elements are
    classified from bond-length patterns: carbon is the default; terminal
    short bonds -> O, long bonds -> S/Cl/Br.  Approximate by construction —
    used only when no SDF/SMILES/blob supplies the real chemistry.

    Returns (atomic_numbers [n], bond pairs).
    """
    from physdock_tpu_torch import native

    pos = np.asarray(pos, np.float32)
    n = len(pos)
    z = np.full(n, 6, np.int32)
    # all-carbon perception with generous scale: rmax = 1.25*(0.76+0.76)
    # = 1.9 A covers C/N/O (1.2-1.6 A), S/Cl (1.7-1.85 A) and Br (1.9 A)
    pairs = native.perceive_bonds(pos, z, scale=1.25)
    lengths = [[] for _ in range(n)]
    for i, j in pairs:
        d = float(np.linalg.norm(pos[i] - pos[j]))
        lengths[i].append(d)
        lengths[j].append(d)
    for i in range(n):
        ds = lengths[i]
        if not ds:
            continue
        if len(ds) == 1:
            d = ds[0]
            if d > 1.86:
                z[i] = 35  # Br
            elif d > 1.68:
                z[i] = 17  # Cl (terminal S is indistinguishable; Cl commoner)
            elif d < 1.38:
                z[i] = 8  # carbonyl/hydroxyl O (N is left as C: ambiguous)
        elif min(ds) > 1.72:
            z[i] = 16  # thioether/ring S
    return z, pairs


# max total heavy-atom bond order (neutral forms; S/P hypervalent allowed;
# N gets 4 to admit nitro/N-oxide/quaternary forms)
_MAX_VALENCE = {1: 1, 5: 3, 6: 4, 7: 4, 8: 2, 9: 1, 14: 4, 15: 5, 16: 6,
                17: 1, 35: 1, 53: 1}

# ratio-classifier boundaries: d / (r_cov(i) + r_cov(j)) against the same
# _ORDER_FACTOR ladder the embedder/restraint field uses (1.0 single,
# 0.93 aromatic, 0.87 double, 0.78 triple; data/embed.py:33).  Boundaries
# sit midway between classes; the aromatic band only applies to PLANAR
# ring bonds, so ester C-O (~0.94) and amide C-N (~0.905) stay single
# while crystal aromatics (benzene 0.914, pyridine 0.91, furan 0.957,
# thiophene 0.945) land inside the band.  The upper edge is generous
# (embedded rings converge with up to ~2% length error) — puckered
# saturated rings are rejected by the planarity gate, not the band.
_AROM_BAND = (0.885, 0.985)
_AROM_PLANARITY = 0.10  # rms out-of-plane per atom, A
_DOUBLE_MAX_RATIO = 0.90
_TRIPLE_MAX_RATIO = 0.825


def _perceive_orders(pos, z, pairs, mol: Molecule) -> Dict:
    """Valence-aware bond-order assignment from geometry.

    1. aromatic rings: 5/6 rings (incl. fused) of sp2-capable atoms whose
       bond-length RATIOS all sit in the aromatic band -> order 1.5;
    2. remaining bonds ascending by ratio: triple then double where the
       boundary admits it AND both atoms have free valence (C=O wins over
       amide C-N automatically: smaller ratio, consumes C's valence first).
    """
    from physdock_tpu_torch.data.embed import _COV_RADII

    orders = {tuple(sorted(p)): 1.0 for p in pairs}
    n = len(z)

    def ratio(i, j):
        d = float(np.linalg.norm(pos[i] - pos[j]))
        return d / (
            _COV_RADII.get(int(z[i]), 1.2) + _COV_RADII.get(int(z[j]), 1.2)
        )

    deg = np.zeros(n, np.int32)
    for i, j in pairs:
        deg[i] += 1
        deg[j] += 1

    # --- aromatic rings (fused systems qualify ring-by-ring)
    for ring in mol.rings():
        if len(ring) not in (5, 6):
            continue
        if not all(int(z[a]) in (6, 7, 8, 16) and deg[a] <= 3 for a in ring):
            continue
        ratios = [
            ratio(ring[k], ring[(k + 1) % len(ring)])
            for k in range(len(ring))
        ]
        pts = pos[ring] - pos[ring].mean(0)
        planar = (
            np.linalg.svd(pts, compute_uv=False)[-1] / np.sqrt(len(ring))
            < _AROM_PLANARITY
        )
        if planar and all(_AROM_BAND[0] <= r <= _AROM_BAND[1] for r in ratios):
            for k in range(len(ring)):
                a, b = ring[k], ring[(k + 1) % len(ring)]
                orders[tuple(sorted((a, b)))] = 1.5

    # --- localized multiple bonds, valence-aware, smallest ratio first.
    # Aromatic (1.5) bonds count 1.0 toward the budget: in the Kekule
    # structure an aromatic atom carrying an exocyclic double bond (e.g.
    # caffeine's ring C=O) has SINGLE ring bonds, so the 1.5 bookkeeping
    # would wrongly veto the exocyclic double.
    val = np.zeros(n, np.float64)
    for (i, j), o in orders.items():
        contrib = 1.0 if o == 1.5 else o
        val[i] += contrib
        val[j] += contrib

    def free(a, amount):
        return val[a] + amount <= _MAX_VALENCE.get(int(z[a]), 4) + 1e-6

    cands = []
    for i, j in pairs:
        key = tuple(sorted((i, j)))
        if orders[key] != 1.0:
            continue
        r = ratio(i, j)
        if r < _TRIPLE_MAX_RATIO and deg[i] <= 2 and deg[j] <= 2:
            cands.append((r, key, 3.0))
        elif r < _DOUBLE_MAX_RATIO:
            cands.append((r, key, 2.0))
    for r, (i, j), o in sorted(cands):
        if orders[(i, j)] != 1.0:
            continue
        extra = o - 1.0
        if free(i, extra) and free(j, extra):
            orders[(i, j)] = o
            val[i] += extra
            val[j] += extra

    # --- hypervalent S/P: terminal oxygens are S=O/P=O regardless of the
    # length ratio (absolute lengths around hypervalent centres sit far
    # from the diatomic ideal — sulfonyl S=O 1.45 vs r_cov sum 1.71 —
    # so the ratio ladder cannot see them); shortest first, valence-capped
    for c in range(n):
        if int(z[c]) not in (15, 16) or deg[c] < 3:
            continue
        term_o = [
            a for a in mol.adjacency[c]
            if int(z[a]) == 8 and deg[a] == 1
            and orders[tuple(sorted((c, a)))] == 1.0
        ]
        for a in sorted(term_o, key=lambda a: ratio(c, a)):
            if free(c, 1.0) and free(a, 1.0):
                orders[tuple(sorted((c, a)))] = 2.0
                val[c] += 1.0
                val[a] += 1.0
    return orders


def molecule_from_positions(
    pos: np.ndarray,
    name: str = "LIG",
    atomic_numbers: Optional[np.ndarray] = None,
) -> Molecule:
    """Build a Molecule graph from heavy-atom coordinates.

    With `atomic_numbers` given (SDF/SMILES/blob supplied elements but no
    bonds), only connectivity + bond orders are perceived; otherwise
    elements are also inferred geometrically (last resort).  Accuracy is
    gated by tests/test_chem_roundtrip.py: embed the fuzz corpus, re-
    perceive from bare coordinates, compare bond orders/aromaticity/
    chirality (>=95% exact with known elements).

    If the perceived graph is disconnected, the closest inter-fragment
    atom pairs are bridged so downstream graph algorithms stay defined.
    """
    from physdock_tpu_torch import native

    pos = np.asarray(pos, np.float32)
    n = len(pos)
    if atomic_numbers is None:
        z, pairs = infer_elements(pos)
    else:
        z = np.asarray(atomic_numbers, np.int32)
        pairs = native.perceive_bonds(pos, z, scale=1.17)

    # connectivity repair (a ligand is a single molecule)
    def components(pairs):
        parent = list(range(n))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i, j in pairs:
            parent[find(i)] = find(j)
        groups = {}
        for i in range(n):
            groups.setdefault(find(i), []).append(i)
        return list(groups.values())

    comps = components(pairs)
    while len(comps) > 1:
        best = None
        a_idx = comps[0]
        for other in comps[1:]:
            d = np.linalg.norm(
                pos[a_idx][:, None] - pos[other][None], axis=-1
            )
            k = np.unravel_index(np.argmin(d), d.shape)
            cand = (float(d[k]), a_idx[k[0]], other[k[1]])
            if best is None or cand[0] < best[0]:
                best = cand
        pairs.append((best[1], best[2]))
        comps = components(pairs)

    mol = Molecule(
        z, np.zeros(n, np.int32), [(i, j, 1.0) for i, j in pairs],
        coords=pos, name=name,
    )
    orders = _perceive_orders(pos, z, pairs, mol)
    bonds = [(i, j, orders[tuple(sorted((i, j)))]) for i, j in pairs]
    out = Molecule(z, np.zeros(n, np.int32), bonds, coords=pos, name=name)
    # charge-separate hypervalent spellings (nitro/azide/N-oxide) exactly
    # as the SMILES/SDF parse path does, so perception from geometry and
    # parsing converge on one canonical graph (data/protomers.py)
    from physdock_tpu_torch.data.protomers import normalize

    return normalize(out)


def entry_from_positions(
    ccd: str, pos: np.ndarray, seed: int = 0
) -> Dict:
    """Last-resort CCD entry reconstructed from GT ligand coordinates.

    Topology comes from geometric perception; the reference conformer is
    RE-EMBEDDED from the recovered graph so GT torsions do not leak into
    the model's ref features (the reference uses the CCD ideal conformer,
    feature_loader.py:138-176).
    """
    from physdock_tpu_torch.data.embed import embed_molecule

    mol = molecule_from_positions(pos, name=ccd)
    rng = np.random.default_rng(seed)
    mol.coords = embed_molecule(mol, rng, n_starts=3, iters=500)
    entry = ligand_entry(mol)
    entry["approximate_chemistry"] = True
    return entry


class CCDLibrary:
    """Lookup + cache of CCD entries.

    Resolution order: explicit external blob (reference-compatible pkl.gz)
    -> standard residue tables -> registered ligand entries."""

    def __init__(self, external_path: Optional[str] = None):
        self._external: Dict[str, Dict] = {}
        if external_path:
            self._external = load_pkl(external_path)
        self._ligands: Dict[str, Dict] = {}

    def register_ligand(self, ccd: str, entry: Dict) -> None:
        self._ligands[ccd] = entry

    def is_external(self, ccd: str) -> bool:
        """True when `ccd` resolves from the authoritative external blob
        (those entries must never be shadowed by coordinate-perceived
        chemistry — feature_loader.load)."""
        return ccd in self._external

    def unregister_ligand(self, ccd: str) -> None:
        """Drop a registered entry (restores external-blob resolution for
        same-code shadows left by a previous system's inline meta)."""
        self._ligands.pop(ccd, None)

    def __contains__(self, ccd: str) -> bool:
        return (
            ccd in self._ligands
            or ccd in self._external
            or (rc.is_standard(ccd) and ccd in rc.AA_ATOMS)
        )

    def __getitem__(self, ccd: str) -> Dict:
        if ccd in self._ligands:
            return self._ligands[ccd]
        if ccd in self._external:
            return self._external[ccd]
        if rc.is_standard(ccd) and ccd in rc.AA_ATOMS:
            return standard_residue_entry(ccd)
        raise KeyError(
            f"CCD {ccd!r} not in library — register the ligand or provide an "
            "external ccd_id_meta_data blob"
        )


def assemble_ref_feat(entry: Dict) -> np.ndarray:
    """167-dim per-atom conditioning feature (feature_loader.py:143-162):
    centred ref_pos(3) + charge(1) + element 1-hot(128) + aromatic(1) +
    degree(9) + hybridization(7) + implicit valence(9) + chirality(3) +
    ring3..8(6)."""
    ref_pos = entry["ref_pos"] - entry["ref_pos"].mean(0, keepdims=True)
    return np.concatenate(
        [
            ref_pos,
            entry["ref_charge"][..., None].astype(np.float32),
            rc.eye_128[entry["ref_element"]],
            entry["ref_is_aromatic"].astype(np.float32)[..., None],
            rc.eye_9[entry["ref_degree"]],
            rc.eye_7[entry["ref_hybridization"]],
            rc.eye_9[entry["ref_implicit_valence"]],
            rc.eye_3[entry["ref_chirality"]],
            entry["ref_in_ring_of_3"].astype(np.float32)[..., None],
            entry["ref_in_ring_of_4"].astype(np.float32)[..., None],
            entry["ref_in_ring_of_5"].astype(np.float32)[..., None],
            entry["ref_in_ring_of_6"].astype(np.float32)[..., None],
            entry["ref_in_ring_of_7"].astype(np.float32)[..., None],
            entry["ref_in_ring_of_8"].astype(np.float32)[..., None],
        ],
        axis=-1,
    ).astype(np.float32)


def assemble_rel_tok_feat(entry: Dict) -> np.ndarray:
    """42-dim intra-conformer pair feature (feature_loader.py:163-171):
    d_token 1-hot(32) + bond type 1-hot(5) + bonded(1) + order-as-double(1) +
    in-ring(1) + conjugated(1) + aromatic(1)."""
    return np.concatenate(
        [
            rc.eye_32[np.minimum(entry["d_token"], 31)],
            rc.eye_5[entry["bond_type"]],
            entry["token_bonds"].astype(np.float32)[..., None],
            entry["bond_as_double"].astype(np.float32)[..., None],
            entry["bond_in_ring"].astype(np.float32)[..., None],
            entry["bond_is_conjugated"].astype(np.float32)[..., None],
            entry["bond_is_aromatic"].astype(np.float32)[..., None],
        ],
        axis=-1,
    ).astype(np.float32)
