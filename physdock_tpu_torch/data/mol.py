"""Molecule graph + ligand featurization (RDKit-free).

Replaces the reference's RDKit featurizer (PhysDock/data/tools/rdkit.py:
get_features_from_ref_mol / get_features_from_smi).  The environment has no
RDKit, so the molecular machinery is built in-house:

  * `Molecule` — atoms, bonds, rings (SSSR-ish cycle basis), aromaticity,
    hybridization/valence heuristics, chirality from 3D geometry;
  * `conformer_features(mol)` — the exact 167-dim ref_feat ingredient dict
    and 42-dim rel_tok_feat ingredient dict contract the featurizer needs
    (feature_loader.py:143-176): ref_pos/charge/element/aromatic/degree/
    hybridization/implicit_valence/chirality/ring3..8 + d_token/bond_type/
    token_bonds/bond flags;
  * SDF (V2000) reading/writing.

SMILES parsing lives in data/smiles.py, 3D embedding in data/embed.py.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.data.constants.periodic_table import (
    SYMBOL_TO_NUMBER,
    element_symbol,
)

# default valences for implicit-H / valence accounting
_DEFAULT_VALENCE = {
    1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 3, 16: 2, 17: 1, 35: 1, 53: 1,
}


@dataclasses.dataclass
class Molecule:
    atomic_numbers: np.ndarray  # [N] int
    charges: np.ndarray  # [N] int
    bonds: List[Tuple[int, int, float]]  # (i, j, order); aromatic -> 1.5
    coords: Optional[np.ndarray] = None  # [N, 3] or None
    name: str = ""

    def __post_init__(self):
        self.atomic_numbers = np.asarray(self.atomic_numbers, np.int32)
        self.charges = np.asarray(self.charges, np.int32)
        if self.coords is not None:
            self.coords = np.asarray(self.coords, np.float32)
        self._rings = None
        # per-atom explicit hydrogen counts (-1 = unspecified): set by the
        # SMILES bracket parser ([nH], [NH3+]) and by remove_hydrogens;
        # overrides the default-valence implicit-H computation
        self.explicit_h: Optional[np.ndarray] = None

    @property
    def num_atoms(self) -> int:
        return len(self.atomic_numbers)

    @property
    def adjacency(self) -> List[List[int]]:
        adj = [[] for _ in range(self.num_atoms)]
        for i, j, _ in self.bonds:
            adj[i].append(j)
            adj[j].append(i)
        return adj

    def bond_order(self, i: int, j: int) -> float:
        for a, b, o in self.bonds:
            if (a, b) == (i, j) or (a, b) == (j, i):
                return o
        return 0.0

    # ----------------------------- rings -----------------------------------

    def rings(self) -> List[List[int]]:
        """Small rings (size 3-8) via BFS shortest-cycle-through-edge."""
        if self._rings is not None:
            return self._rings
        adj = self.adjacency
        found = set()
        out: List[List[int]] = []
        for i, j, _ in self.bonds:
            cyc = self._shortest_cycle_through(i, j, adj)
            if cyc is not None and 3 <= len(cyc) <= 8:
                key = frozenset(cyc)
                if key not in found:
                    found.add(key)
                    out.append(cyc)
        self._rings = out
        return out

    def _shortest_cycle_through(self, i, j, adj):
        # shortest path i->j avoiding the direct edge; cycle = path + edge
        prev = {i: None}
        q = deque([i])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if u == i and v == j:
                    continue
                if v not in prev:
                    prev[v] = u
                    if v == j:
                        path = [v]
                        while prev[path[-1]] is not None:
                            path.append(prev[path[-1]])
                        return path
                    q.append(v)
        return None

    def atom_rings_of_size(self, size: int) -> np.ndarray:
        mask = np.zeros(self.num_atoms, np.int8)
        for ring in self.rings():
            if len(ring) == size:
                mask[list(ring)] = 1
        return mask

    def bond_in_ring(self, i: int, j: int) -> bool:
        for ring in self.rings():
            rs = set(ring)
            if i in rs and j in rs:
                # consecutive in some ring
                n = len(ring)
                for k in range(n):
                    a, b = ring[k], ring[(k + 1) % n]
                    if {a, b} == {i, j}:
                        return True
        return False

    # --------------------------- aromaticity --------------------------------

    def aromatic_atoms(self) -> np.ndarray:
        """Atoms on aromatic bonds, plus a Hückel-ish heuristic for rings of
        alternating single/double bonds (SDF files often use Kekulé form)."""
        arom = np.zeros(self.num_atoms, np.int8)
        for i, j, o in self.bonds:
            if o == 1.5:
                arom[i] = arom[j] = 1
        # Kekulé detection: 5/6-rings where every atom is sp2-ish
        for ring in self.rings():
            if len(ring) not in (5, 6):
                continue
            ok = True
            for idx in range(len(ring)):
                a = ring[idx]
                z = int(self.atomic_numbers[a])
                if z not in (6, 7, 8, 16):
                    ok = False
                    break
                # every ring atom needs a double/aromatic bond or lone pair donor
                has_pi = any(
                    o >= 1.5 or o == 2
                    for i, j, o in self.bonds
                    if a in (i, j)
                )
                if z == 6 and not has_pi:
                    ok = False
                    break
            if ok:
                n_double = sum(
                    1
                    for i, j, o in self.bonds
                    if o == 2 and i in ring and j in ring
                )
                if n_double * 2 >= len(ring) - 2:
                    arom[list(ring)] = 1
        return arom

    def aromatic_bond(self, i: int, j: int) -> bool:
        if self.bond_order(i, j) == 1.5:
            return True
        arom = self.aromatic_atoms()
        return bool(arom[i] and arom[j] and self.bond_in_ring(i, j))

    # ------------------------- atom-level heuristics ------------------------

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.num_atoms, np.int8)
        for i, j, _ in self.bonds:
            d[i] += 1
            d[j] += 1
        return np.minimum(d, 8)

    def explicit_valence(self) -> np.ndarray:
        v = np.zeros(self.num_atoms, np.float32)
        for i, j, o in self.bonds:
            v[i] += o
            v[j] += o
        return v

    def implicit_valence(self) -> np.ndarray:
        """Implicit hydrogens: default valence + charge adjustment - explicit.
        Atoms with a recorded explicit H count ([nH]/[NH3+] brackets, or
        hydrogens stripped by remove_hydrogens) use that count directly."""
        ev = self.explicit_valence()
        out = np.zeros(self.num_atoms, np.int8)
        arom = self.aromatic_atoms()
        for a in range(self.num_atoms):
            if self.explicit_h is not None and self.explicit_h[a] >= 0:
                out[a] = min(int(self.explicit_h[a]), 8)
                continue
            z = int(self.atomic_numbers[a])
            dv = _DEFAULT_VALENCE.get(z, 0)
            chg = int(self.charges[a])
            if z == 7 or z == 15:
                dv += max(chg, -abs(chg))
            elif z in (8, 16):
                dv += chg
            elif z == 6:
                dv -= abs(chg)
            e = ev[a]
            if arom[a] and e == int(e) + 0.5:
                e = np.ceil(e)
            out[a] = max(0, int(round(dv - e)))
        return np.minimum(out, 8)

    def hybridizations(self) -> np.ndarray:
        """0=S 1=SP 2=SP2 3=SP3 4=SP3D 5=SP3D2 6=other (tools/rdkit.py:31-38)."""
        arom = self.aromatic_atoms()
        deg = self.degrees()
        impl = self.implicit_valence()
        out = np.full(self.num_atoms, 3, np.int8)
        for a in range(self.num_atoms):
            orders = [o for i, j, o in self.bonds if a in (i, j)]
            n_nbr = int(deg[a]) + int(impl[a])  # heavy + implicit H
            if not orders:
                out[a] = 0
                continue
            n_double = sum(1 for o in orders if o == 2)
            n_triple = sum(1 for o in orders if o == 3)
            if n_triple or n_double >= 2:
                out[a] = 1
            elif arom[a] or n_double == 1:
                out[a] = 2
            elif n_nbr >= 6:
                out[a] = 5
            elif n_nbr == 5:
                out[a] = 4
            else:
                out[a] = 3
        return out

    # ----------------------------- chirality --------------------------------

    def chiral_tags(self) -> np.ndarray:
        """0=CW 1=CCW 2=unspecified, from 3D geometry at stereocentres
        (reference takes RDKit tags; here the tag is the signed volume over
        canonically-ranked neighbours — self-consistent with
        chiral_centers())."""
        tags = np.full(self.num_atoms, 2, np.int8)
        if self.coords is None:
            return tags
        for centre, nbrs in self.chiral_centers():
            a, b, c, d = (self.coords[n] for n in nbrs)
            vol = np.dot(np.cross(b - a, c - a), d - a)
            if abs(vol) > 1e-2:
                tags[centre] = 0 if vol > 0 else 1
        return tags

    def chiral_centers(self) -> List[Tuple[int, Tuple[int, int, int, int]]]:
        """Potential tetrahedral stereocentres: sp3 atoms with 4 distinct
        heavy-atom neighbourhoods (3 neighbours + implicit H also counts when
        the 3 are distinct).  Neighbour order is by canonical Morgan rank.
        Used for the chirality feature, the FF chirality wells, and the
        accept/reject test (replacing redocking.py:231-239)."""
        ranks = self.canonical_ranks()
        adj = self.adjacency
        out = []
        for a in range(self.num_atoms):
            nbrs = adj[a]
            if len(nbrs) < 3 or len(nbrs) > 4:
                continue
            z = int(self.atomic_numbers[a])
            if z not in (6, 7, 15, 16):
                continue
            r = [ranks[n] for n in nbrs]
            if len(set(r)) != len(r):
                continue  # symmetric neighbours -> not a stereocentre
            ordered = [n for _, n in sorted(zip(r, nbrs))]
            if len(ordered) == 3:
                ordered = [a] + ordered  # centre stands in for implicit H
            out.append((a, tuple(ordered[:4])))
        return out

    def canonical_ranks(self) -> np.ndarray:
        """Morgan-style canonical ranks (iterative neighbourhood refinement)."""
        n = self.num_atoms
        adj = self.adjacency
        inv = [
            (int(self.atomic_numbers[a]), int(self.charges[a]), len(adj[a]))
            for a in range(n)
        ]
        ranks = _rank(inv)
        for _ in range(n):
            new_inv = [
                (ranks[a], tuple(sorted(ranks[x] for x in adj[a]))) for a in range(n)
            ]
            new_ranks = _rank(new_inv)
            if np.array_equal(new_ranks, ranks):
                break
            ranks = new_ranks
        return ranks

    # ----------------------------- topology ---------------------------------

    def shortest_path_matrix(self, cap: int = 30) -> np.ndarray:
        """All-pairs bond-graph distances, capped (tools/rdkit.py:146-155
        measures len(path)-1 then caps at 30)."""
        n = self.num_atoms
        adj = self.adjacency
        d = np.full((n, n), cap, np.int8)
        for s in range(n):
            d[s, s] = 0
            q = deque([s])
            dist = {s: 0}
            while q:
                u = q.popleft()
                for v in adj[u]:
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        d[s, v] = min(cap, dist[v])
                        q.append(v)
        return d

    def rotatable_bonds(self) -> List[Tuple[int, int]]:
        """Single, non-ring bonds between non-terminal atoms (torsion DOFs
        for the conformer generator)."""
        deg = self.degrees()
        out = []
        for i, j, o in self.bonds:
            if o != 1:
                continue
            if deg[i] < 2 or deg[j] < 2:
                continue
            if self.bond_in_ring(i, j):
                continue
            out.append((i, j))
        return out


def _rank(invariants) -> np.ndarray:
    order = {inv: r for r, inv in enumerate(sorted(set(invariants)))}
    return np.array([order[i] for i in invariants], np.int32)


# --------------------------- featurization ----------------------------------


def conformer_features(mol: Molecule, ref_pos: Optional[np.ndarray] = None) -> Dict:
    """Per-atom + pair features with the reference contract
    (tools/rdkit.py:100-215).  `ref_pos` defaults to mol.coords."""
    n = mol.num_atoms
    if ref_pos is None:
        ref_pos = mol.coords
    assert ref_pos is not None, "molecule needs 3D coordinates (embed first)"
    arom = mol.aromatic_atoms()
    d_token = mol.shortest_path_matrix(cap=30)

    token_bonds = np.zeros((n, n), np.int8)
    bond_type = np.zeros((n, n), np.int8)
    bond_as_double = np.zeros((n, n), np.int8)
    bond_in_ring = np.zeros((n, n), np.int8)
    bond_is_conjugated = np.zeros((n, n), np.int8)
    bond_is_aromatic = np.zeros((n, n), np.int8)
    conj = _conjugated_bonds(mol)
    for i, j, o in mol.bonds:
        token_bonds[i, j] = token_bonds[j, i] = 1
        bt = {1.0: 0, 2.0: 1, 3.0: 2, 1.5: 3}.get(o, 4)
        if mol.aromatic_bond(i, j):
            bt = 3
        bond_type[i, j] = bond_type[j, i] = bt
        bond_as_double[i, j] = bond_as_double[j, i] = int(o if o != 1.5 else 1)
        ring = int(mol.bond_in_ring(i, j))
        bond_in_ring[i, j] = bond_in_ring[j, i] = ring
        bond_is_aromatic[i, j] = bond_is_aromatic[j, i] = int(mol.aromatic_bond(i, j))
        bond_is_conjugated[i, j] = bond_is_conjugated[j, i] = int((i, j) in conj or (j, i) in conj)

    return {
        "ref_pos": np.asarray(ref_pos, np.float32),
        "ref_charge": mol.charges.astype(np.float32),
        "ref_element": (mol.atomic_numbers - 1).astype(np.int8),
        "ref_is_aromatic": arom,
        "ref_degree": mol.degrees(),
        "ref_hybridization": mol.hybridizations(),
        "ref_implicit_valence": mol.implicit_valence(),
        "ref_chirality": mol.chiral_tags(),
        "ref_in_ring_of_3": mol.atom_rings_of_size(3),
        "ref_in_ring_of_4": mol.atom_rings_of_size(4),
        "ref_in_ring_of_5": mol.atom_rings_of_size(5),
        "ref_in_ring_of_6": mol.atom_rings_of_size(6),
        "ref_in_ring_of_7": mol.atom_rings_of_size(7),
        "ref_in_ring_of_8": mol.atom_rings_of_size(8),
        "d_token": d_token,
        "token_bonds": token_bonds,
        "bond_type": bond_type,
        "bond_as_double": bond_as_double,
        "bond_in_ring": bond_in_ring,
        "bond_is_conjugated": bond_is_conjugated,
        "bond_is_aromatic": bond_is_aromatic,
        "ref_atom_name_chars": [
            element_symbol(int(z)) for z in mol.atomic_numbers
        ],
        "ref_mask_in_polymer": [1] * n,
    }


def _conjugated_bonds(mol: Molecule) -> set:
    """Bonds adjacent to two pi systems (simple conjugation heuristic)."""
    pi_atom = np.zeros(mol.num_atoms, bool)
    for i, j, o in mol.bonds:
        if o >= 1.5:
            pi_atom[i] = pi_atom[j] = True
    return {(i, j) for i, j, o in mol.bonds if pi_atom[i] and pi_atom[j]}


# ------------------------------- SDF IO -------------------------------------


def read_sdf(path_or_text: str, remove_hs: bool = True) -> Molecule:
    """Parse the first molecule of an SDF / MOL (V2000) file."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    lines = text.splitlines()
    name = lines[0].strip() if lines else ""
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    coords, elements, charges = [], [], []
    for ln in lines[4 : 4 + n_atoms]:
        coords.append([float(ln[0:10]), float(ln[10:20]), float(ln[20:30])])
        elements.append(SYMBOL_TO_NUMBER[ln[31:34].strip().upper()])
        charges.append(0)
    bonds = []
    for ln in lines[4 + n_atoms : 4 + n_atoms + n_bonds]:
        i, j, t = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
        order = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}.get(t, 1.0)
        bonds.append((i, j, order))
    # M  CHG lines
    for ln in lines[4 + n_atoms + n_bonds :]:
        if ln.startswith("M  CHG"):
            parts = ln.split()
            k = int(parts[2])
            for c in range(k):
                idx = int(parts[3 + 2 * c]) - 1
                charges[idx] = int(parts[4 + 2 * c])
        if ln.startswith("M  END"):
            break
    mol = Molecule(
        np.array(elements), np.array(charges), bonds, np.array(coords), name
    )
    return remove_hydrogens(mol) if remove_hs else mol


def remove_hydrogens(mol: Molecule) -> Molecule:
    keep = mol.atomic_numbers != 1
    remap = -np.ones(mol.num_atoms, np.int32)
    remap[keep] = np.arange(int(keep.sum()))
    bonds = [
        (int(remap[i]), int(remap[j]), o)
        for i, j, o in mol.bonds
        if keep[i] and keep[j]
    ]
    # record stripped H counts so implicit_valence stays chemistry-true
    # for charged/odd-valence atoms after removal
    n_h = np.zeros(mol.num_atoms, np.int32)
    for i, j, _ in mol.bonds:
        if not keep[i] and keep[j]:
            n_h[j] += 1
        elif not keep[j] and keep[i]:
            n_h[i] += 1
    out = Molecule(
        mol.atomic_numbers[keep],
        mol.charges[keep],
        bonds,
        mol.coords[keep] if mol.coords is not None else None,
        mol.name,
    )
    if n_h[keep].any():
        eh = np.full(out.num_atoms, -1, np.int8)
        if mol.explicit_h is not None:
            eh = mol.explicit_h[keep].copy()
        had_h = n_h[keep] > 0
        eh[had_h] = np.minimum(n_h[keep][had_h], 8)
        out.explicit_h = eh
    elif mol.explicit_h is not None:
        out.explicit_h = mol.explicit_h[keep].copy()
    return out


def write_sdf(
    mol: Molecule, coords: Optional[np.ndarray] = None, name: Optional[str] = None
) -> str:
    """Serialize to a V2000 SDF block."""
    coords = mol.coords if coords is None else np.asarray(coords)
    n, nb = mol.num_atoms, len(mol.bonds)
    # the program line of the JAX package's writer: both write the same bytes
    lines = [name or mol.name or "ligand", "  physdock_tpu", ""]
    lines.append(
        f"{n:>3}{nb:>3}  0  0  0  0  0  0  0  0999 V2000"
    )
    for a in range(n):
        x, y, z = coords[a]
        sym = element_symbol(int(mol.atomic_numbers[a]))
        lines.append(
            f"{x:>10.4f}{y:>10.4f}{z:>10.4f} {sym:<3} 0  0  0  0  0  0  0  0  0  0  0  0"
        )
    for i, j, o in mol.bonds:
        t = {1.0: 1, 2.0: 2, 3.0: 3, 1.5: 4}.get(o, 1)
        lines.append(f"{i + 1:>3}{j + 1:>3}{t:>3}  0")
    chg = [(a, int(c)) for a, c in enumerate(mol.charges) if c]
    if chg:
        for grp in range(0, len(chg), 8):
            part = chg[grp : grp + 8]
            lines.append(
                "M  CHG" + f"{len(part):>3}" + "".join(f"{a + 1:>4}{c:>4}" for a, c in part)
            )
    lines += ["M  END", "$$$$"]
    return "\n".join(lines) + "\n"
