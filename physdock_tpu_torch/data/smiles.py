"""SMILES parser (RDKit-free) -> Molecule.

Supports the organic subset + brackets, branches, ring closures (incl. %nn),
bond orders -/=/#/:, aromatic lowercase atoms, charges, tetrahedral
@/@@ tags, and directional E/Z bond tags (/ and \\) — double-bond stereo
becomes `Molecule.stereo_bonds` entries that the embedder pins as planar
1-4 distance restraints and the guidance force field preserves as rigid
1-4 pairs.  Replaces `Chem.MolFromSmiles` in the screening entry path
(reference: tools/rdkit.py:14-28, screening.py:106-116).  Hydrogens are
implicit (the whole pipeline is heavy-atom-only, matching the reference's
RemoveAllHs).

Known-unsupported (documented fuzz frontier):
  * directional tags on ring-closure bonds (rare; tag ignored, bond kept);
  * @TH1/@AL/@SP/@TB/@OH extended chirality classes (bracket parse keeps
    the atom, the tag is ignored);
  * isotope labels parsed but not featurized;
  * wildcard '*' atoms are treated as carbon.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.data.constants.periodic_table import SYMBOL_TO_NUMBER
from physdock_tpu_torch.data.mol import Molecule

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC = {"b", "c", "n", "o", "p", "s"}

_BRACKET_RE = re.compile(
    r"\[(?P<iso>\d+)?(?P<sym>[A-Za-z][a-z]?|\*)(?P<chiral>@{1,2})?"
    r"(?P<hcount>H\d*)?(?P<charge>[+-]+\d*|\+\d+|-\d+)?(?::\d+)?\]"
)


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str) -> Molecule:
    atoms: List[int] = []  # atomic numbers
    charges: List[int] = []
    aromatic_atom: List[bool] = []
    chiral: List[Optional[str]] = []
    hcounts: List[int] = []  # explicit H count; -1 = unspecified (organic subset)
    bonds: List[Tuple[int, int, float]] = []

    prev: List[Optional[int]] = [None]  # stack of attachment points
    pending_bond: Optional[float] = None
    pending_dir: Optional[int] = None  # +1 for '/', -1 for '\'
    dir_bonds: List[Tuple[int, int, int]] = []  # (written-first, second, dir)
    ring_open: Dict[str, Tuple[int, Optional[float]]] = {}

    i = 0
    n = len(smiles)

    def add_atom(z, charge, arom, chi, hcount=-1):
        atoms.append(z)
        charges.append(charge)
        aromatic_atom.append(arom)
        chiral.append(chi)
        hcounts.append(hcount)
        return len(atoms) - 1

    def close_bond(a, b, order):
        if order is None:
            order = 1.5 if (aromatic_atom[a] and aromatic_atom[b]) else 1.0
        bonds.append((a, b, order))

    while i < n:
        ch = smiles[i]
        if ch == "(":
            prev.append(prev[-1])
            i += 1
        elif ch == ")":
            if len(prev) < 2:
                raise SmilesError(f"unbalanced ')' in {smiles}")
            prev.pop()
            i += 1
        elif ch in "-=#:$":
            pending_bond = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5, "$": 4.0}[ch]
            pending_dir = None
            i += 1
        elif ch in "/\\":
            pending_bond = 1.0
            pending_dir = 1 if ch == "/" else -1
            i += 1
        elif ch == ".":
            prev[-1] = None
            pending_bond = None
            pending_dir = None
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                label = smiles[i + 1 : i + 3]
                i += 3
            else:
                label = ch
                i += 1
            if label in ring_open:
                a, order_open = ring_open.pop(label)
                order = pending_bond if pending_bond is not None else order_open
                close_bond(a, prev[-1], order)
            else:
                ring_open[label] = (prev[-1], pending_bond)
            pending_bond = None
            pending_dir = None
        elif ch == "[":
            m = _BRACKET_RE.match(smiles, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {i} in {smiles}")
            sym = m.group("sym")
            arom = sym[0].islower()
            z = SYMBOL_TO_NUMBER.get(sym.capitalize().upper() if len(sym) == 1 else sym.capitalize().upper())
            if sym == "*":
                z = 6
            if z is None:
                raise SmilesError(f"unknown element {sym}")
            chg = 0
            cs = m.group("charge")
            if cs:
                if cs in ("+", "-"):
                    chg = 1 if cs == "+" else -1
                elif cs[0] in "+-" and cs[1:].isdigit():
                    chg = int(cs[1:]) * (1 if cs[0] == "+" else -1)
                else:
                    chg = cs.count("+") - cs.count("-")
            hs = m.group("hcount")
            hcount = 0 if hs is None else (1 if hs == "H" else int(hs[1:]))
            idx = add_atom(z, chg, arom, m.group("chiral"), hcount)
            if prev[-1] is not None:
                close_bond(prev[-1], idx, pending_bond)
                if pending_dir is not None:
                    dir_bonds.append((prev[-1], idx, pending_dir))
            prev[-1] = idx
            pending_bond = None
            pending_dir = None
            i = m.end()
        else:
            # organic subset, maybe two letters (Cl, Br)
            two = smiles[i : i + 2]
            if two in ("Cl", "Br"):
                sym, arom = two, False
                i += 2
            elif ch in _ORGANIC:
                sym, arom = ch, False
                i += 1
            elif ch in _AROMATIC:
                sym, arom = ch.upper(), True
                i += 1
            else:
                raise SmilesError(f"unexpected '{ch}' at {i} in {smiles}")
            z = SYMBOL_TO_NUMBER[sym.upper()]
            idx = add_atom(z, 0, arom, None)
            if prev[-1] is not None:
                close_bond(prev[-1], idx, pending_bond)
                if pending_dir is not None:
                    dir_bonds.append((prev[-1], idx, pending_dir))
            prev[-1] = idx
            pending_bond = None
            pending_dir = None

    if ring_open:
        raise SmilesError(f"unclosed ring bonds {list(ring_open)} in {smiles}")

    mol = Molecule(
        np.array(atoms, np.int32), np.array(charges, np.int32), bonds, None, smiles
    )
    mol._smiles_chirality = chiral  # CW/CCW tags, applied post-embedding
    mol.stereo_bonds = _derive_stereo_bonds(bonds, dir_bonds)
    if any(h >= 0 for h in hcounts):
        mol.explicit_h = np.array(hcounts, np.int8)
    return mol


def _derive_stereo_bonds(bonds, dir_bonds):
    """Directional single bonds -> double-bond stereo descriptors.

    Returns (a, i, j, b, is_trans) tuples: substituent a of double-bond
    atom i and substituent b of j.  SMILES semantics: for a directional
    bond written X/Y, orient its sign toward the double-bond atom; equal
    oriented signs on the two sides = cis, opposite = trans
    (F/C=C/F is trans-difluoroethene).
    """
    out = []
    for i, j, o in bonds:
        if o != 2.0:
            continue
        flags = {}
        for end in (i, j):
            for x, y, s in dir_bonds:
                if y == end and x not in (i, j):
                    flags[end] = (x, s)  # recorded toward the sp2 atom
                    break
                if x == end and y not in (i, j):
                    flags[end] = (y, -s)  # recorded away: flip
                    break
        if i in flags and j in flags:
            a, fa = flags[i]
            b, fb = flags[j]
            out.append((a, i, j, b, fa != fb))
    return out


def mol_from_smiles(
    smiles: str,
    embed: bool = True,
    seed: int = 0,
    normalize: bool = True,
    protonate_ph: Optional[float] = None,
    canonical_tautomer: bool = False,
) -> Molecule:
    """Parse + 3D-embed (equivalent of get_ref_mol: MolFromSmiles ->
    EmbedMolecule -> RemoveAllHs; tools/rdkit.py:14-28).  `normalize`
    mirrors RDKit sanitization's charge-separation cleanup; `protonate_ph`
    / `canonical_tautomer` are the opt-in ligand-prep extensions
    (data/protomers.py).  Graph transforms run before embedding so the
    conformer matches the final bond orders."""
    mol = parse_smiles(smiles)
    if normalize or protonate_ph is not None or canonical_tautomer:
        from physdock_tpu_torch.data import protomers

        if protonate_ph is not None:
            mol = protomers.adjust_protonation(mol, ph=protonate_ph)
        elif normalize:
            mol = protomers.normalize(mol)
        if canonical_tautomer:
            mol = protomers.canonical_tautomer(mol)
    if embed:
        from physdock_tpu_torch.data.embed import embed_molecule

        rng = np.random.default_rng(seed)
        signs = _smiles_chirality_signs(mol)
        mol.coords = embed_molecule(mol, rng, chiral_signs=signs)
    return mol


def _smiles_chirality_signs(mol: Molecule):
    """Translate @/@@ tags into signed-volume targets over neighbours in
    SMILES-encounter order: looking from the first neighbour, @ = CCW."""
    tags = getattr(mol, "_smiles_chirality", None)
    if not tags:
        return []
    adj_order: List[List[int]] = [[] for _ in range(mol.num_atoms)]
    for i, j, _ in mol.bonds:
        adj_order[i].append(j)
        adj_order[j].append(i)
    out = []
    for a, tag in enumerate(tags):
        if tag is None:
            continue
        nbrs = adj_order[a]
        if len(nbrs) < 3:
            continue
        ordered = nbrs[:4]
        if len(ordered) == 3:
            ordered = [a] + ordered
        # '@' (CCW) -> negative signed volume in our convention, '@@' positive
        sign = -1.0 if tag == "@" else 1.0
        out.append((a, tuple(ordered), sign))
    return out
