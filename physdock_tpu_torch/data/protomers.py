"""Protonation-state and tautomer handling for the in-house chem stack.

The reference delegates all molecule sanitization to RDKit:
``Chem.MolFromSmiles`` (reference: PhysDock/data/tools/rdkit.py:14-28
``get_ref_mol``; screening.py:106-116) runs RDKit's sanitization, whose
cleanup phase charge-separates hypervalent spellings (nitro ``N(=O)=O``
-> ``[N+](=O)[O-]``, azides, N-oxides) before featurization reads formal
charges (``atom.GetFormalCharge()`` -> the 167-dim ref_feat).  RDKit does
NOT tautomer-canonicalize or re-protonate on parse, so for strict parity
only `normalize` runs by default; `adjust_protonation` (physiological-pH
formal charges) and `canonical_tautomer` are opt-in extensions surfaced
as screening flags (the usual ligand-prep steps a user would otherwise
run through RDKit/dimorphite before the reference pipeline).

Everything operates on the heavy-atom ``Molecule`` graph (hydrogens are
implicit, matching the reference's RemoveAllHs pipeline); "protonation"
therefore means formal-charge + implicit-H bookkeeping, which feeds
ref_charge / ref_implicit_valence and the guidance force field.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.data.mol import Molecule

Bond = Tuple[int, int, float]


def _clone(
    mol: Molecule,
    bonds: Optional[List[Bond]] = None,
    charges: Optional[np.ndarray] = None,
    explicit_h: Optional[np.ndarray] = None,
) -> Molecule:
    out = Molecule(
        mol.atomic_numbers.copy(),
        mol.charges.copy() if charges is None else np.asarray(charges, np.int32),
        list(mol.bonds) if bonds is None else list(bonds),
        None if mol.coords is None else mol.coords.copy(),
        mol.name,
    )
    eh = getattr(mol, "explicit_h", None) if explicit_h is None else explicit_h
    if eh is not None:
        out.explicit_h = np.asarray(eh, np.int8)
    for attr in ("stereo_bonds", "_smiles_chirality"):
        if hasattr(mol, attr):
            setattr(out, attr, getattr(mol, attr))
    return out


def _neighbors(mol: Molecule, a: int) -> List[Tuple[int, float, int]]:
    """(neighbor, order, bond_index) triples of atom a."""
    out = []
    for bi, (i, j, o) in enumerate(mol.bonds):
        if i == a:
            out.append((j, o, bi))
        elif j == a:
            out.append((i, o, bi))
    return out


def total_h_counts(mol: Molecule) -> np.ndarray:
    """Chemistry-true hydrogen count per heavy atom: the SMILES/SDF
    explicit count when recorded, else the default-valence computation."""
    eh = getattr(mol, "explicit_h", None)
    iv = mol.implicit_valence()
    out = iv.astype(np.int32)
    if eh is not None:
        spec = np.asarray(eh) >= 0
        out[spec] = np.asarray(eh)[spec]
    return out


# --------------------------------------------------------------------------
# normalize: RDKit-cleanup-style charge separation
# --------------------------------------------------------------------------


def normalize(mol: Molecule) -> Molecule:
    """Charge-separate hypervalent main-group spellings the way RDKit's
    sanitization cleanup does (nitro, azide, N-oxide); placement of the
    remaining double bond is index-canonical so perception from geometry
    and parsing from SMILES converge on one graph.  Idempotent."""
    bonds = list(mol.bonds)
    charges = mol.charges.copy()
    deg = np.zeros(mol.num_atoms, np.int32)
    for i, j, _ in bonds:
        deg[i] += 1
        deg[j] += 1

    def set_order(bi, o):
        i, j, _ = bonds[bi]
        bonds[bi] = (i, j, o)

    for a in range(mol.num_atoms):
        if int(mol.atomic_numbers[a]) != 7:
            continue
        nbrs = _neighbors(mol, a)
        if charges[a] == 1:
            # already charge-separated nitro: re-place the double bond on
            # the lower-index terminal O (idempotent canonical form)
            t_dbl = [
                n for n, o, _ in nbrs
                if o == 2 and int(mol.atomic_numbers[n]) == 8 and deg[n] == 1
                and charges[n] == 0
            ]
            t_neg = [
                n for n, o, _ in nbrs
                if o == 1 and int(mol.atomic_numbers[n]) == 8 and deg[n] == 1
                and charges[n] == -1
            ]
            if len(t_dbl) == 1 and len(t_neg) == 1 and t_neg[0] < t_dbl[0]:
                for n, o, bi in nbrs:
                    if n == t_neg[0]:
                        set_order(bi, 2.0)
                    elif n == t_dbl[0]:
                        set_order(bi, 1.0)
                charges[t_neg[0]] = 0
                charges[t_dbl[0]] = -1
            continue
        if charges[a] != 0:
            continue
        ev = sum(o for _, o, _ in nbrs)
        term_o_double = sorted(
            n for n, o, _ in nbrs
            if o == 2 and int(mol.atomic_numbers[n]) == 8 and deg[n] == 1
        )
        # nitro: neutral N with >=2 terminal oxygens and excess valence
        # (covers the hypervalent N(=O)=O spelling AND the perceiver's
        # uncharged 2/1 assignment) -> [N+](=O)[O-], double bond placed
        # index-canonically so both paths converge on one graph
        term_o = sorted(
            n for n, o, _ in nbrs
            if int(mol.atomic_numbers[n]) == 8 and deg[n] == 1
            and charges[n] == 0
        )
        if len(term_o) >= 2 and ev > 3:
            keep = term_o[0]
            for n, o, bi in nbrs:
                if n == keep:
                    set_order(bi, 2.0)
                elif n in term_o[1:]:
                    set_order(bi, 1.0)
            charges[a] = 1
            charges[term_o[1]] = -1
            continue
        # azide: -N=[N]=[N] -> -N=[N+]=[N-] (central N has two N doubles)
        nn_double = [
            n for n, o, _ in nbrs if o == 2 and int(mol.atomic_numbers[n]) == 7
        ]
        if len(nn_double) == 2 and ev >= 4:
            charges[a] = 1
            term = [n for n in nn_double if deg[n] == 1]
            if term and charges[term[0]] == 0:
                charges[term[0]] = -1
            continue
        # N-oxide (incl. aromatic): neutral N with explicit valence > 3 and
        # one terminal double-bonded O -> single bond, N+ / O-
        if ev > 3 and len(term_o_double) == 1:
            drop = term_o_double[0]
            for n, o, bi in nbrs:
                if n == drop:
                    set_order(bi, 1.0)
            charges[a] = 1
            charges[drop] = -1
    return _clone(mol, bonds=bonds, charges=charges)


# --------------------------------------------------------------------------
# adjust_protonation: physiological-pH formal charges
# --------------------------------------------------------------------------


def adjust_protonation(mol: Molecule, ph: float = 7.4) -> Molecule:
    """Assign formal charges for the common ionizable groups at the given
    pH (rule-based, pKa thresholds; the heavy-atom analogue of standard
    ligand prep).  Deprotonates carboxylic/sulfonic/phosphonic acids and
    tetrazoles; protonates aliphatic amines, amidines and guanidines.
    Aromatic amines, pyridines, imidazoles, phenols and thiols stay
    neutral at 7.4.  Only touches atoms that are currently neutral."""
    mol = normalize(mol)
    charges = mol.charges.copy()
    eh = total_h_counts(mol)
    new_eh = eh.copy()
    arom = mol.aromatic_atoms()
    z = mol.atomic_numbers
    deg = mol.degrees()

    def is_terminal_hydroxyl(o_idx):
        return (
            int(z[o_idx]) == 8
            and deg[o_idx] == 1
            and charges[o_idx] == 0
            and eh[o_idx] >= 1
        )

    rings = mol.rings()
    for a in range(mol.num_atoms):
        if charges[a] != 0:
            continue
        za = int(z[a])
        nbrs = _neighbors(mol, a)

        # ---- acids ----
        if za == 6:
            # carboxylic acid pKa ~4: C(=O)OH
            has_carbonyl = any(
                o == 2 and int(z[n]) == 8 for n, o, _ in nbrs
            )
            oh = [n for n, o, _ in nbrs if o == 1 and is_terminal_hydroxyl(n)]
            if has_carbonyl and oh and ph > 4.5:
                charges[oh[0]] = -1
                new_eh[oh[0]] = 0
        elif za == 16:
            # sulfonic/sulfinic acid pKa ~ -1..2
            n_double_o = sum(
                1 for n, o, _ in nbrs if o == 2 and int(z[n]) == 8
            )
            oh = [n for n, o, _ in nbrs if o == 1 and is_terminal_hydroxyl(n)]
            if n_double_o >= 1 and oh and ph > 2.0:
                charges[oh[0]] = -1
                new_eh[oh[0]] = 0
        elif za == 15:
            # phosphate/phosphonate: pKa1 ~2 always at 7.4; pKa2 ~7.2
            n_double_o = sum(
                1 for n, o, _ in nbrs if o == 2 and int(z[n]) == 8
            )
            oh = sorted(
                n for n, o, _ in nbrs if o == 1 and is_terminal_hydroxyl(n)
            )
            if n_double_o >= 1 and oh:
                take = 1 + (1 if ph >= 7.2 and len(oh) > 1 else 0)
                for n in oh[:take]:
                    charges[n] = -1
                    new_eh[n] = 0
        elif za == 7:
            # tetrazole N-H pKa ~4.9: aromatic 5-ring with 4 nitrogens
            in_tetrazole = any(
                len(r) == 5
                and a in r
                and sum(int(z[x]) == 7 for x in r) >= 4
                and all(arom[x] for x in r)
                for r in rings
            )
            if in_tetrazole and eh[a] >= 1 and ph > 4.9:
                charges[a] = -1
                new_eh[a] = 0
                continue

            # ---- bases ----
            if arom[a]:
                continue  # pyridine/imidazole/azole: neutral at 7.4
            orders = [o for _, o, _ in nbrs]
            if any(o >= 2 for o in orders):
                # amidine / guanidine: C(-N)=N with no aromatic member
                dbl_c = [
                    n for n, o, _ in nbrs
                    if o == 2 and int(z[n]) == 6 and not arom[n]
                ]
                if dbl_c and ph < 11.0:
                    c = dbl_c[0]
                    n_single_n = sum(
                        1
                        for n2, o2, _ in _neighbors(mol, c)
                        if o2 == 1 and int(z[n2]) == 7
                    )
                    if n_single_n >= 1:  # amidine (1) or guanidine (2)
                        charges[a] = 1
                        new_eh[a] = eh[a] + 1
                continue
            # aliphatic amine pKa ~10: sp3 N, all-single bonds, no
            # aromatic / carbonyl / sulfonyl / N / O neighbor
            bad = False
            for n, o, _ in nbrs:
                zn = int(z[n])
                if arom[n] or zn in (7, 8, 16):
                    bad = True
                    break
                if zn == 6 and any(
                    o2 == 2 and int(z[n2]) in (8, 16)
                    for n2, o2, _ in _neighbors(mol, n)
                ):
                    bad = True  # amide/thioamide/carbamate
                    break
                if zn == 16:
                    bad = True  # sulfonamide
                    break
            if not bad and deg[a] <= 3 and ph < 9.5:
                charges[a] = 1
                new_eh[a] = eh[a] + 1

    return _clone(mol, charges=charges, explicit_h=new_eh.astype(np.int8))


# --------------------------------------------------------------------------
# tautomers: 1,3 H-shift enumeration + scored canonical pick
# --------------------------------------------------------------------------


def _state_key(bonds: List[Bond], hs: np.ndarray):
    return (
        tuple(sorted((min(i, j), max(i, j), o) for i, j, o in bonds)),
        tuple(int(x) for x in hs),
    )


def enumerate_tautomers(
    mol: Molecule, max_tautomers: int = 32, max_depth: int = 4
) -> List[Molecule]:
    """Enumerate 1,3-prototropic tautomers (keto/enol, amide/imidol,
    imine/enamine, thione/thiol): move an H from donor D across D-A=B to
    B, flipping the bond orders.  Aromatic atoms are left untouched (the
    perceiver already abstracts those pi systems to order 1.5), pure
    C->C shifts are skipped (as RDKit's enumerator does), and the search
    is BFS-bounded.  The input molecule is always element 0."""
    arom = mol.aromatic_atoms()
    z = mol.atomic_numbers
    hetero = {7, 8, 16}

    start = (list(mol.bonds), total_h_counts(mol).astype(np.int32))
    seen = {_state_key(*start)}
    out_states = [start]
    frontier = [start]
    depth = 0
    while frontier and len(out_states) < max_tautomers and depth < max_depth:
        nxt = []
        for bonds, hs in frontier:
            order = {}
            adj: List[List[int]] = [[] for _ in range(mol.num_atoms)]
            for i, j, o in bonds:
                order[(i, j)] = order[(j, i)] = o
                adj[i].append(j)
                adj[j].append(i)
            for d in range(mol.num_atoms):
                if hs[d] < 1 or arom[d]:
                    continue
                for a in adj[d]:
                    if arom[a] or order[(d, a)] != 1.0:
                        continue
                    for b in adj[a]:
                        if b == d or arom[b] or order[(a, b)] != 2.0:
                            continue
                        if int(z[d]) not in hetero and int(z[b]) not in hetero:
                            continue  # skip pure alkene shifts
                        nb = [
                            (
                                i,
                                j,
                                2.0
                                if {i, j} == {d, a}
                                else (1.0 if {i, j} == {a, b} else o),
                            )
                            for i, j, o in bonds
                        ]
                        nh = hs.copy()
                        nh[d] -= 1
                        nh[b] += 1
                        key = _state_key(nb, nh)
                        if key in seen:
                            continue
                        seen.add(key)
                        st = (nb, nh)
                        out_states.append(st)
                        nxt.append(st)
                        if len(out_states) >= max_tautomers:
                            break
                    if len(out_states) >= max_tautomers:
                        break
                if len(out_states) >= max_tautomers:
                    break
        frontier = nxt
        depth += 1

    return [
        _clone(mol, bonds=b, explicit_h=h.astype(np.int8))
        for b, h in out_states
    ]


def tautomer_score(mol: Molecule) -> float:
    """Stability score, RDKit-TautomerEnumerator-style subset: aromatic
    rings dominate, then carbonyl/thiocarbonyl preference (amide over
    imidol, keto over enol), then a small penalty per heteroatom-H (keeps
    N-H/O-H counts low when otherwise tied)."""
    arom = mol.aromatic_atoms()
    n_arom_rings = sum(
        1 for r in mol.rings() if all(arom[a] for a in r)
    )
    z = mol.atomic_numbers
    n_carbonyl = n_hetero_double = 0
    for i, j, o in mol.bonds:
        if o != 2.0:
            continue
        zi, zj = int(z[i]), int(z[j])
        if (zi == 6 and zj in (8, 16)) or (zj == 6 and zi in (8, 16)):
            n_carbonyl += 1
        elif zi in (7, 8, 15, 16) and zj in (7, 8, 15, 16):
            n_hetero_double += 1
    hs = total_h_counts(mol)
    hetero_h = sum(
        int(hs[a]) for a in range(mol.num_atoms) if int(z[a]) in (7, 8, 16)
    )
    return 100.0 * n_arom_rings + 4.0 * n_carbonyl + 2.0 * n_hetero_double - 1.0 * hetero_h


def canonical_tautomer(mol: Molecule, max_tautomers: int = 32) -> Molecule:
    """Highest-scoring tautomer; deterministic tie-break on the bond
    multiset so the pick is stable across enumeration order."""
    cands = enumerate_tautomers(mol, max_tautomers=max_tautomers)
    return max(
        cands,
        key=lambda m: (
            tautomer_score(m),
            _state_key(m.bonds, total_h_counts(m)),
        ),
    )
