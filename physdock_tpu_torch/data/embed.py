"""Conformer embedding: molecular graph -> 3D coordinates (RDKit-free).

Replaces RDKit `EmbedMolecule` / `EmbedMultipleConfs` (used by the reference
for SMILES ligands and the physics-guidance conformer bank —
tools/rdkit.py:21, models/model.py:176-196).  Distance-geometry-lite:

  1. derive ideal bond lengths (covalent radii x order factor), 1-3
     distances (law of cosines over hybridization/ring angles), planarity
     restraints for aromatic rings, and soft nonbonded repulsion;
  2. minimize the restraint loss from random starts with Adam (numpy,
     analytic gradients — molecules are tiny, host-side);
  3. conformer banks: resample torsions around rotatable bonds, re-minimize.

Chirality: after embedding, mirror (z -> -z) + re-minimize when a target
tetrahedral sign set is violated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.data.mol import Molecule

# covalent radii (Angstrom)
_COV_RADII = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 35: 1.20, 53: 1.39,
}
_ORDER_FACTOR = {1.0: 1.0, 1.5: 0.93, 2.0: 0.87, 3.0: 0.78}
_VDW = {1: 1.1, 6: 1.7, 7: 1.55, 8: 1.52, 9: 1.47, 15: 1.8, 16: 1.8, 17: 1.75,
        35: 1.85, 53: 1.98}


def ideal_bond_length(z1: int, z2: int, order: float) -> float:
    r = _COV_RADII.get(z1, 1.2) + _COV_RADII.get(z2, 1.2)
    return r * _ORDER_FACTOR.get(order, 1.0)


@dataclasses.dataclass
class RestraintSet:
    pairs: np.ndarray  # [P, 2] int
    targets: np.ndarray  # [P]
    weights: np.ndarray  # [P]
    rep_pairs: np.ndarray  # [R, 2]
    rep_dist: np.ndarray  # [R]
    chiral: List[Tuple[int, Tuple[int, int, int, int], float]]  # (centre, nbrs, sign)
    # (a, centre, b, ideal_angle_rad) triples — populated alongside the 1-3
    # distance restraints; consumed by infer/relax.check_pose's bond-angle
    # criterion (PoseBusters checks angles, not 1-3 distances)
    angles: Optional[List[Tuple[int, int, int, float]]] = None


def _ring_layout_2d(edges, elems):
    """Planar layout of one ring with the given edge lengths and
    element-aware interior-angle priors (C-S-C 92 deg, C-O-C 106.5,
    N 108; carbons absorb the closure).  A regular-polygon assumption is
    WRONG for heterocycles — thiophene's 92-degree sulfur angle vs the
    pentagon's 108 made the 1-3 restraints inconsistent with closure and
    the only 3D compromise was ring pucker.

    edges[k] is the length (atom k -> k+1); elems[k] the atomic number of
    atom k.  Returns [m, 2] coordinates."""
    m = len(edges)
    # heteroatom angle priors matter in 5-rings (thiophene S 92 deg vs the
    # pentagon's 108); in 6-rings the regular 120 is within ~3 deg of
    # reality (pyridine N 117) so no prior is pinned
    prior = (
        {16: math.radians(92.0), 8: math.radians(106.5),
         7: math.radians(108.0)}
        if m == 5
        else {}
    )
    interior = np.full(m, 0.0)
    fixed = np.zeros(m, bool)
    for k, zk in enumerate(elems):
        if int(zk) in prior:
            interior[k] = prior[int(zk)]
            fixed[k] = True
    total = (m - 2) * math.pi
    n_free = int(np.sum(~fixed))
    if n_free:
        interior[~fixed] = (total - interior[fixed].sum()) / n_free
    else:
        interior *= total / interior.sum()

    def walk(inter):
        pts = np.zeros((m, 2))
        theta = 0.0
        for k in range(1, m):
            pts[k] = pts[k - 1] + edges[k - 1] * np.array(
                [math.cos(theta), math.sin(theta)]
            )
            theta += math.pi - inter[k]
        return pts

    # Newton-ish correction of the free angles to close the ring
    for _ in range(40):
        pts = walk(interior)
        closure = pts[0] - (
            pts[-1]
            + edges[-1]
            * np.array(
                [
                    math.cos(sum(math.pi - interior[k] for k in range(1, m))),
                    math.sin(sum(math.pi - interior[k] for k in range(1, m))),
                ]
            )
        )
        err = float(np.linalg.norm(closure))
        if err < 1e-4:
            break
        free_idx = np.nonzero(~fixed)[0]
        if not len(free_idx):
            free_idx = np.arange(m)
        J = np.zeros((2, len(free_idx)))
        h = 1e-5
        for c, k in enumerate(free_idx):
            pert = interior.copy()
            pert[k] += h
            p2 = walk(pert)
            c2 = p2[0] - (
                p2[-1]
                + edges[-1]
                * np.array(
                    [
                        math.cos(sum(math.pi - pert[q] for q in range(1, m))),
                        math.sin(sum(math.pi - pert[q] for q in range(1, m))),
                    ]
                )
            )
            J[:, c] = (c2 - closure) / h
        try:
            delta, *_ = np.linalg.lstsq(J, -closure, rcond=None)
        except np.linalg.LinAlgError:
            break
        interior[free_idx] += np.clip(delta, -0.2, 0.2)
    return walk(interior)


def _fused_aromatic_layouts(mol, arom, bond_len):
    """Exact 2D layouts of fused aromatic ring systems.

    Returns one {atom: xy} dict per system of >=2 aromatic rings sharing
    an edge: the first ring is placed as a regular polygon, each fused
    ring is grown outward on its shared edge.  Spiro/bridged systems that
    do not fit this construction are skipped (best-effort)."""
    rings = [r for r in mol.rings() if len(r) >= 5 and all(arom[a] for a in r)]
    if len(rings) < 2:
        return []
    # group rings sharing >= 2 atoms
    parent = list(range(len(rings)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            if len(set(rings[i]) & set(rings[j])) >= 2:
                parent[find(i)] = find(j)
    groups = {}
    for i in range(len(rings)):
        groups.setdefault(find(i), []).append(i)

    layouts = []
    for group in groups.values():
        if len(group) < 2:
            continue
        try:
            pos: dict = {}
            z = mol.atomic_numbers

            def solved_layout(ring):
                m = len(ring)
                edges = [
                    bond_len[(ring[k], ring[(k + 1) % m])] for k in range(m)
                ]
                return _ring_layout_2d(edges, [int(z[a]) for a in ring])

            def place_ring(ring, u=None, v=None):
                m = len(ring)
                if u is None:  # first ring: solved shape at origin
                    lay = solved_layout(ring)
                    for k, a in enumerate(ring):
                        pos[a] = lay[k]
                    return
                # orient the ring cycle so u -> v are consecutive
                ku = ring.index(u)
                if ring[(ku + 1) % m] != v:
                    ring = ring[::-1]
                    ku = ring.index(u)
                    if ring[(ku + 1) % m] != v:
                        raise ValueError("shared edge not consecutive")
                ring = ring[ku:] + ring[:ku]  # starts u, v, ...
                lay = solved_layout(ring)
                # rigid-transform lay so lay[0]->pos[u], lay[1]->pos[v]
                sv = lay[1] - lay[0]
                dv = pos[v] - pos[u]
                ang = math.atan2(dv[1], dv[0]) - math.atan2(sv[1], sv[0])
                R = np.array(
                    [[math.cos(ang), -math.sin(ang)],
                     [math.sin(ang), math.cos(ang)]]
                )
                cand = {
                    a: R @ (lay[k] - lay[0]) + pos[u]
                    for k, a in enumerate(ring)
                }
                # the new ring must grow AWAY from what is already placed:
                # reflect across the shared edge if centroids share a side
                dvn = dv / (np.linalg.norm(dv) + 1e-9)

                def side(p):
                    r = p - pos[u]
                    return dvn[0] * r[1] - dvn[1] * r[0]

                placed_c = np.mean(list(pos.values()), axis=0)
                cand_c = np.mean(list(cand.values()), axis=0)
                if side(cand_c) * side(placed_c) > 0:
                    for a in cand:
                        r = cand[a] - pos[u]
                        par = np.dot(r, dvn) * dvn
                        cand[a] = pos[u] + 2 * par - r
                for a, p in cand.items():
                    if a not in pos:
                        pos[a] = p

            remaining = [rings[i] for i in group]
            place_ring(remaining.pop(0))
            guard = 0
            while remaining and guard < 50:
                guard += 1
                for k, ring in enumerate(remaining):
                    shared = [
                        (ring[i], ring[(i + 1) % len(ring)])
                        for i in range(len(ring))
                        if ring[i] in pos and ring[(i + 1) % len(ring)] in pos
                    ]
                    if shared:
                        place_ring(list(ring), shared[0][0], shared[0][1])
                        remaining.pop(k)
                        break
                else:
                    break
            if not remaining:
                layouts.append(pos)
        except Exception:
            continue
    return layouts


def build_restraints(mol: Molecule, chiral_signs=None) -> RestraintSet:
    n = mol.num_atoms
    adj = mol.adjacency
    hyb = mol.hybridizations()
    z = mol.atomic_numbers
    ring_sets = [set(r) for r in mol.rings()]

    pairs, targets, weights = [], [], []
    angles: List[Tuple[int, int, int, float]] = []
    seen = set()

    def add(i, j, r0, w):
        key = (min(i, j), max(i, j))
        if key in seen:
            return
        seen.add(key)
        pairs.append(key)
        targets.append(r0)
        weights.append(w)

    bond_len = {}
    for i, j, o in mol.bonds:
        r0 = ideal_bond_length(int(z[i]), int(z[j]), o)
        bond_len[(i, j)] = bond_len[(j, i)] = r0
        add(i, j, r0, 20.0)

    # planarity of aromatic/small rings: intra-ring distances from the
    # EXACT planar layout (element-aware angles — see _ring_layout_2d),
    # plus exocyclic-substituent chords that pin substituents INTO the
    # ring plane (without them, substituted rings converged ~0.2 A out of
    # plane — above PoseBusters' 0.25 A flatness margin once docking
    # noise adds on top)
    arom = mol.aromatic_atoms()
    for ring in mol.rings():
        m = len(ring)
        if m < 4:
            continue
        planar = all(arom[a] for a in ring) or m <= 5
        if not planar:
            continue
        edges = [bond_len[(ring[k], ring[(k + 1) % m])] for k in range(m)]
        lay = _ring_layout_2d(edges, [int(z[ring[k]]) for k in range(m)])
        for k in range(m):
            for l in range(k + 2, m):
                if (k == 0 and l == m - 1):
                    continue
                # ring planarity must win against substituent sterics —
                # real rings stay flat and push strain into torsions
                add(ring[k], ring[l],
                    float(np.linalg.norm(lay[k] - lay[l])), 16.0)
        if not all(arom[a] for a in ring):
            continue
        centre = lay.mean(0)
        rset = set(ring)
        for k, r0 in enumerate(ring):
            for s in adj[r0]:
                if s in rset:
                    continue
                b = bond_len[(r0, s)]
                out = lay[k] - centre
                out = out / (np.linalg.norm(out) + 1e-9)
                s_pos = lay[k] + b * out
                for sep in (2, m - 2):
                    t = (k + sep) % m
                    add(s, ring[t],
                        float(np.linalg.norm(s_pos - lay[t])), 4.0)

    # fused aromatic systems are COPLANAR as a whole, not just ring-by-ring
    # (per-ring chords alone let indole book-fold along the fusion bond):
    # lay the system out exactly in 2D, then restrain every intra-system
    # pair to its planar distance
    for system_pos in _fused_aromatic_layouts(mol, arom, bond_len):
        atoms = sorted(system_pos)
        for ii in range(len(atoms)):
            for jj in range(ii + 1, len(atoms)):
                a, b = atoms[ii], atoms[jj]
                d = float(
                    np.linalg.norm(system_pos[a] - system_pos[b])
                )
                add(a, b, d, 12.0)

    # 1-3 distances by centre-atom angle
    for c in range(n):
        nbrs = adj[c]
        if len(nbrs) < 2:
            continue
        ring_angle = None
        for rs, ring in zip(ring_sets, mol.rings()):
            if c in rs:
                m = len(ring)
                inset = {x for x in nbrs if x in rs}
                if len(inset) >= 2 and m <= 6:
                    ring_angle = math.pi * (m - 2) / m
        base = {1: math.pi, 2: math.radians(120), 3: math.radians(109.47)}.get(
            int(hyb[c]) if hyb[c] in (1, 2, 3) else 3, math.radians(109.47)
        )
        for ii in range(len(nbrs)):
            for jj in range(ii + 1, len(nbrs)):
                a, b = nbrs[ii], nbrs[jj]
                ang = base
                if ring_angle is not None and any(
                    a in rs and b in rs and c in rs for rs in ring_sets
                ):
                    ang = ring_angle
                ra, rb = bond_len[(c, a)], bond_len[(c, b)]
                d13 = math.sqrt(ra**2 + rb**2 - 2 * ra * rb * math.cos(ang))
                add(a, b, d13, 8.0)
                angles.append((a, c, b, ang))

    # sp2 substituent planarity via 1-4 over double bonds is approximated by
    # repulsion + angle restraints; skip explicit torsions.

    # E/Z double-bond stereo: pin the specified substituents' 1-4 distance
    # to the planar trans/cis geometry (from SMILES directional tags)
    for a, bi, bj, b, is_trans in getattr(mol, "stereo_bonds", None) or []:
        r_ij = bond_len.get((bi, bj))
        r_ai = bond_len.get((a, bi))
        r_jb = bond_len.get((bj, b))
        if None in (r_ij, r_ai, r_jb):
            continue
        apos = np.array(
            [-0.5 * r_ai, math.sin(2 * math.pi / 3) * r_ai]
        )
        theta = -math.pi / 3 if is_trans else math.pi / 3
        bpos = np.array(
            [r_ij + r_jb * math.cos(theta), r_jb * math.sin(theta)]
        )
        add(a, b, float(np.linalg.norm(apos - bpos)), 10.0)

    restrained = set(seen)
    rep_pairs, rep_dist = [], []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) in restrained:
                continue
            rep_pairs.append((i, j))
            rep_dist.append(0.85 * (_VDW.get(int(z[i]), 1.7) + _VDW.get(int(z[j]), 1.7)))

    chiral = []
    if chiral_signs:
        for centre, nbrs, sign in chiral_signs:
            chiral.append((centre, nbrs, sign))

    return RestraintSet(
        pairs=np.array(pairs or [(0, 0)], np.int32),
        targets=np.array(targets or [0.0], np.float32),
        weights=np.array(weights or [0.0], np.float32),
        rep_pairs=np.array(rep_pairs or [(0, 0)], np.int32),
        rep_dist=np.array(rep_dist or [0.0], np.float32),
        chiral=chiral,
        angles=angles,
    )


def _loss_and_grad(x: np.ndarray, rs: RestraintSet):
    """Restraint loss + gradient; x may be [N, 3] or batched [C, N, 3]
    (the conformer bank refines every sample in one vectorized pass)."""
    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    g = np.zeros_like(xb)
    i, j = rs.pairs[:, 0], rs.pairs[:, 1]
    dvec = xb[:, i] - xb[:, j]  # [C, P, 3]
    d = np.linalg.norm(dvec, axis=-1) + 1e-9
    diff = d - rs.targets
    loss = np.sum(rs.weights * diff**2, axis=-1)  # [C]
    gpair = (2 * rs.weights * diff / d)[..., None] * dvec
    np.add.at(g, (slice(None), i), gpair)
    np.add.at(g, (slice(None), j), -gpair)

    ri, rj = rs.rep_pairs[:, 0], rs.rep_pairs[:, 1]
    rvec = xb[:, ri] - xb[:, rj]
    rd = np.linalg.norm(rvec, axis=-1) + 1e-9
    viol = np.maximum(rs.rep_dist - rd, 0.0)
    loss = loss + np.sum(2.0 * viol**2, axis=-1)
    grep = (-4.0 * viol / rd)[..., None] * rvec
    np.add.at(g, (slice(None), ri), grep)
    np.add.at(g, (slice(None), rj), -grep)
    if squeeze:
        return float(loss[0]), g[0]
    return loss, g


def _minimize(x: np.ndarray, rs: RestraintSet, iters: int = 300, lr: float = 0.05):
    m = np.zeros_like(x)
    v = np.zeros_like(x)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, iters + 1):
        # cosine decay over the last half polishes to the restraint floor
        # (fixed-lr Adam oscillates ~0.1 A around it — enough to unflatten
        # aromatic rings)
        frac = t / iters
        cur = lr if frac < 0.5 else lr * 0.5 * (
            1.0 + math.cos(math.pi * (frac - 0.5) / 0.5)
        )
        loss, g = _loss_and_grad(x, rs)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        x = x - cur * mh / (np.sqrt(vh) + eps)
    return x, _loss_and_grad(x, rs)[0]


def _chirality_violations(x: np.ndarray, rs: RestraintSet):
    """Violation count; scalar for [N, 3], [C] array for batched input."""
    squeeze = x.ndim == 2
    xb = x[None] if squeeze else x
    bad = np.zeros(xb.shape[0], np.int32)
    for centre, (a, b, c, d), sign in rs.chiral:
        vol = np.einsum(
            "ci,ci->c",
            np.cross(xb[:, b] - xb[:, a], xb[:, c] - xb[:, a]),
            xb[:, d] - xb[:, a],
        )
        bad += (vol * sign < 0).astype(np.int32)
    if squeeze:
        return int(bad[0])
    return bad


def _dg_init(rs: RestraintSet, n: int, rng: np.random.Generator) -> np.ndarray:
    """Distance-geometry initialization (ETKDG-style, rdkit.py's engine in
    the reference): complete the restraint targets to a full distance
    matrix via shortest paths, then classical MDS to 3D.

    Random-gaussian starts + Adam get stuck in folded local minima (rings
    puckered 0.2 A out of plane even with planarity restraints in the
    loss); MDS lands in the right global fold and the minimizer only
    polishes."""
    big = 1e6
    D = np.full((n, n), big)
    np.fill_diagonal(D, 0.0)
    for (i, j), t in zip(rs.pairs, rs.targets):
        D[i, j] = D[j, i] = min(D[i, j], t)
    # Floyd-Warshall completion (n is ligand-sized; vectorized over rows)
    for k in range(n):
        D = np.minimum(D, D[:, k][:, None] + D[k][None, :])
    D = np.where(D >= big, np.nanmax(np.where(D < big, D, np.nan)), D)
    D = D * (1.0 + rng.normal(0.0, 0.015, D.shape))  # per-start diversity
    D = 0.5 * (D + D.T)
    # classical MDS
    J = np.eye(n) - 1.0 / n
    B = -0.5 * J @ (D**2) @ J
    w, V = np.linalg.eigh(B)
    idx = np.argsort(w)[::-1][:3]
    x = V[:, idx] * np.sqrt(np.maximum(w[idx], 1e-6))[None, :]
    if rng.random() < 0.5:
        x = x * np.array([1.0, 1.0, -1.0])  # sample both mirror images
    return x + rng.normal(0, 0.05, x.shape)


def embed_molecule(
    mol: Molecule,
    rng: Optional[np.random.Generator] = None,
    n_starts: int = 4,
    iters: int = 400,
    chiral_signs=None,
    enforce_chirality: bool = True,
) -> np.ndarray:
    """Embed one conformer. Returns [N, 3] float32 (centred)."""
    rng = rng or np.random.default_rng(0)
    rs = build_restraints(mol, chiral_signs)
    n = mol.num_atoms
    best, best_loss = None, np.inf
    for s in range(n_starts):
        if n >= 4 and s < max(1, n_starts - 1):
            x0 = _dg_init(rs, n, rng)
        else:  # one random start keeps torsional diversity
            x0 = rng.normal(0, 1.5 * max(1.0, n ** (1 / 3)), (n, 3))
        x, loss = _minimize(x0, rs, iters)
        if enforce_chirality and rs.chiral and _chirality_violations(x, rs):
            xm = x * np.array([1.0, 1.0, -1.0])
            xm, lm = _minimize(xm, rs, iters // 2)
            if _chirality_violations(xm, rs) < _chirality_violations(x, rs):
                x, loss = xm, lm
        if loss < best_loss:
            best, best_loss = x, loss
    return (best - best.mean(0)).astype(np.float32)


def _component_atoms(mol: Molecule, bond: Tuple[int, int]) -> np.ndarray:
    """Atoms on the j-side after removing bond (i, j)."""
    i, j = bond
    adj = mol.adjacency
    seen = {i, j}
    stack = [j]
    comp = []
    while stack:
        u = stack.pop()
        comp.append(u)
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return np.array(comp, np.int32)


def randomize_torsions(
    mol: Molecule, coords: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Rotate each rotatable bond by a random angle (torsion resampling)."""
    x = coords.copy()
    for i, j in mol.rotatable_bonds():
        comp = _component_atoms(mol, (i, j))
        if len(comp) == 0 or len(comp) >= mol.num_atoms - 1:
            continue
        axis = x[j] - x[i]
        axis = axis / (np.linalg.norm(axis) + 1e-9)
        theta = rng.uniform(0, 2 * np.pi)
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        R = np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)
        x[comp] = (x[comp] - x[j]) @ R.T + x[j]
    return x


def generate_conformers(
    mol: Molecule,
    num_confs: int = 128,
    rng: Optional[np.random.Generator] = None,
    refine_iters: int = 120,
    base_coords: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Torsion-sampled conformer bank [C, N, 3] (replacement for
    `EmbedMultipleConfs(numConfs, enforceChirality=True)` —
    models/model.py:176-189).  Conformer 0 is the base embedding."""
    rng = rng or np.random.default_rng(0)
    chiral_signs = _measured_chirality(mol, base_coords)
    rs = build_restraints(mol, chiral_signs)
    if base_coords is None:
        base = embed_molecule(mol, rng, chiral_signs=chiral_signs)
    else:
        base = np.asarray(base_coords, np.float32)
    if num_confs == 1:
        return (base - base.mean(0))[None].astype(np.float32)
    # torsion-resample all conformers, then refine them as ONE batched
    # minimization (the per-conformer python loop dominated VS host time)
    xs = np.stack(
        [randomize_torsions(mol, base, rng) for _ in range(num_confs - 1)]
    )
    xs, _ = _minimize(xs, rs, refine_iters)
    if rs.chiral:
        viol = _chirality_violations(xs, rs)
        bad = viol > 0
        if bad.any():
            xm, _ = _minimize(
                xs[bad] * np.array([1.0, 1.0, -1.0]), rs, refine_iters // 2
            )
            better = _chirality_violations(xm, rs) < viol[bad]
            idx = np.flatnonzero(bad)[better]
            xs[idx] = xm[better]
    out = np.concatenate([(base - base.mean(0))[None], xs - xs.mean(1, keepdims=True)])
    return out.astype(np.float32)


def _measured_chirality(mol: Molecule, coords: Optional[np.ndarray]):
    """Chirality targets measured on given coordinates (or mol.coords)."""
    ref = coords if coords is not None else mol.coords
    if ref is None:
        return []
    out = []
    for centre, nbrs in mol.chiral_centers():
        a, b, c, d = (ref[k] for k in nbrs)
        vol = float(np.dot(np.cross(b - a, c - a), d - a))
        if abs(vol) > 1e-2:
            out.append((centre, nbrs, math.copysign(1.0, vol)))
    return out
