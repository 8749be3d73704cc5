"""Post-docking structure relaxation + pose validity checks (port of
`physdock_tpu/infer/relax.py`).

Replaces the reference's OpenMM/PDBFixer relaxation (data/relaxation.py:
243-259: amber14+GBN2, harmonic restraints k=1e8 on CA+ligand, brief
minimization) with the in-house restraint field, NumPy on the host:
receptor atoms are restrained to their predicted positions (strongly for
CA, softly for side chains), ligand internal geometry is restored by its
restraints, and receptor-ligand clashes are pushed apart.  Also provides
PoseBusters-style validity checks (`check_pose`) replacing
relaxation.get_bust_results (reference: data/relaxation.py:29-50).  Both
are host post-processing: `check_pose`'s force-field terms run on CPU
tensors, so neither ever touches the card.

Neither replacement has been cross-run against the real OpenMM/PoseBusters
packages (unavailable offline); the check-by-check divergence surface is
documented in docs/RELAX_POSEBUSTERS_DIVERGENCE.md.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from physdock_tpu_torch.data.embed import ideal_bond_length
from physdock_tpu_torch.data.mol import Molecule

_VDW = {1: 1.1, 6: 1.7, 7: 1.55, 8: 1.52, 9: 1.47, 15: 1.8, 16: 1.8,
        17: 1.75, 35: 1.85, 53: 1.98}


def relax_complex(
    x_pred: np.ndarray,  # [A, 3]
    meta: Dict,
    iters: int = 100,
    ca_restraint: float = 100.0,
    sidechain_restraint: float = 1.0,
    clash_weight: float = 10.0,
    elec_weight: float = 0.5,
) -> np.ndarray:
    """Minimize ligand strain + interface clashes with the receptor pinned.

    Pure-numpy gradient descent (host-side post-processing; sizes are
    small).  The interface force field is united-atom: implicit hydrogens
    inflate heavy-atom radii, and ligand (PEOE) vs receptor (typed
    amber-style) partial charges add a Coulomb term with the classic
    distance-dependent dielectric eps = 4r — the in-house stand-in for the
    reference's amber14+GBN2 minimization (data/relaxation.py:243-259).
    """
    mol: Optional[Molecule] = meta.get("ref_mol")
    lig_idx = np.asarray(meta["ligand_atom_idx"])
    if mol is None or len(lig_idx) != mol.num_atoms:
        return x_pred
    names = meta["atom_names"]
    if len(names) < len(x_pred):
        # pose arrays carry bucket padding past the real atoms; relax the
        # real prefix and pass the padding through untouched
        if len(lig_idx) and int(lig_idx.max()) >= len(names):
            return x_pred
        out = np.array(x_pred, np.float32)
        out[: len(names)] = relax_complex(
            x_pred[: len(names)], meta, iters, ca_restraint,
            sidechain_restraint, clash_weight, elec_weight,
        )
        return out
    x = np.array(x_pred, np.float64)
    anchor = x.copy()

    is_ca = np.array([n.strip() == "CA" for n in names], bool)
    is_lig = np.zeros(len(x), bool)
    is_lig[lig_idx] = True

    # receptor atoms near the ligand (the mobile shell)
    d_min = np.min(
        np.linalg.norm(x[:, None][~is_lig] - x[None][:, is_lig], axis=-1), axis=-1
    )
    shell = np.zeros(len(x), bool)
    shell[~is_lig] = d_min < 8.0

    # ligand restraint set (bond/1-3/rigid-1-4 targets) — per-molecule, cached
    rs = _cached_restraints(mol)
    zl = mol.atomic_numbers

    lr = 5e-3
    rec_idx = np.nonzero(shell)[0]

    # united-atom radii + partial charges (computed once per call)
    from physdock_tpu_torch.data.charges import (
        gasteiger_charges,
        receptor_charges_from_meta,
    )
    from physdock_tpu_torch.data.protomers import total_h_counts

    nh = total_h_counts(mol)
    lig_vdw = np.array([_VDW.get(int(z), 1.7) for z in zl]) + np.minimum(
        0.1 * nh, 0.3
    )
    q_lig = q_rec = None
    if elec_weight > 0 and len(rec_idx):
        try:
            q_lig = getattr(mol, "_peoe_cache", None)
            if q_lig is None:
                q_lig = gasteiger_charges(mol)
                try:
                    mol._peoe_cache = q_lig
                except Exception:
                    pass
            q_rec = receptor_charges_from_meta(meta, rec_idx)
            if not np.any(q_rec):
                q_lig = q_rec = None
        except Exception:
            q_lig = q_rec = None

    for _ in range(iters):
        g = np.zeros_like(x)
        # ligand internal restraints
        li, lj = rs.pairs[:, 0], rs.pairs[:, 1]
        gi, gj = lig_idx[li], lig_idx[lj]
        dv = x[gi] - x[gj]
        d = np.linalg.norm(dv, axis=-1) + 1e-9
        coef = (2 * rs.weights * (d - rs.targets) / d)[:, None] * dv
        np.add.at(g, gi, coef)
        np.add.at(g, gj, -coef)
        # ligand-receptor clash repulsion + electrostatics
        if len(rec_idx):
            dv = x[lig_idx][:, None] - x[rec_idx][None]
            d = np.linalg.norm(dv, axis=-1) + 1e-9
            rmin = 0.85 * (lig_vdw[:, None] + 1.6)
            viol = np.maximum(rmin - d, 0.0)
            coef = (-2 * clash_weight * viol / d)[..., None] * dv
            if q_lig is not None:
                # E = w * (332/4) * q_i q_j / d^2  (eps = 4d); grad wrt
                # x_lig is dE/dd * dv/d = -2 E / d^2 * dv.  Distance is
                # floored at vdW contact so attraction can never beat the
                # clash wall at short range.
                de = np.maximum(d, 2.5)
                e_ij = (
                    elec_weight * 83.0 * np.outer(q_lig, q_rec) / (de * de)
                )
                live = (d >= 2.5).astype(np.float64)  # flat inside the floor
                coef = coef + (-2.0 * e_ij * live / (de * d))[..., None] * dv
            np.add.at(g, lig_idx, coef.sum(axis=1))
            np.add.at(g, rec_idx, -coef.sum(axis=0))
        # positional restraints
        k_pos = np.where(is_ca, ca_restraint, np.where(is_lig, 0.0, sidechain_restraint))
        g += 2 * k_pos[:, None] * (x - anchor)
        # frozen receptor outside the shell
        g[~(shell | is_lig)] = 0.0
        step = lr * g
        norm = np.linalg.norm(step, axis=-1, keepdims=True)
        step *= np.minimum(1.0, 0.05 / (norm + 1e-9))
        x -= step
    return x.astype(np.float32)


def _cached_restraints(mol: Molecule):
    """RestraintSet for `mol`, computed once and stashed on the object
    (rings/hybridization/angle targets are per-molecule, not per-pose)."""
    rs = getattr(mol, "_restraints_cache", None)
    if rs is None:
        from physdock_tpu_torch.data.embed import build_restraints

        rs = build_restraints(mol)
        try:
            mol._restraints_cache = rs
        except Exception:  # frozen/slotted object: recompute next time
            pass
    return rs


def _graph_distances(mol: Molecule) -> np.ndarray:
    """All-pairs bond-graph distances, cached on the molecule."""
    gd = getattr(mol, "_graph_dist_cache", None)
    if gd is None:
        gd = mol.shortest_path_matrix(cap=30)
        try:
            mol._graph_dist_cache = gd
        except Exception:
            pass
    return gd


def _receptor_vdw(names) -> np.ndarray:
    """Per-atom vdW radii for receptor atoms from PDB atom names (heavy
    atoms only; protein context, so 'CA' is carbon-alpha not calcium)."""
    radii = np.empty(len(names), np.float64)
    for i, nm in enumerate(names):
        c = nm.strip()[:1].upper()
        radii[i] = {"C": 1.7, "N": 1.55, "O": 1.52, "S": 1.8, "P": 1.8}.get(c, 1.7)
    return radii


def check_pose(
    x_pred: np.ndarray,
    meta: Dict,
    bond_tol: float = 0.25,
    clash_factor: float = 0.7,
) -> Dict:
    """PoseBusters-style validity checks (reference: data/relaxation.py:29-50
    shells out to the PoseBusters package; here the checks are native).

    Thresholds follow PoseBusters semantics: bond lengths/angles within
    [0.75, 1.25] x ideal; internal steric clash when non-bonded atoms (>= 3
    bonds apart) come closer than 0.7 x their vdW contact distance (1-4
    pairs get a looser 0.55 x bound — distance-geometry lower bounds allow
    short cis-torsion contacts); receptor clash when a ligand-receptor pair
    is closer than 0.75 x vdW contact; aromatic/double-bond flatness within
    0.25 A.  Each check reports a violation COUNT alongside its boolean.
    """
    mol: Optional[Molecule] = meta.get("ref_mol")
    lig_idx = np.asarray(meta["ligand_atom_idx"])
    out = {"has_ligand": mol is not None and len(lig_idx) == getattr(mol, "num_atoms", -1)}
    if not out["has_ligand"]:
        return out
    x_pred = np.asarray(x_pred)
    if meta.get("atom_names") is not None:
        # pose arrays carry bucket padding past the real atoms (relax.py:48
        # handles the same); padded rows sit at the origin and would read
        # as phantom receptor clashes
        x_pred = x_pred[: len(meta["atom_names"])]
    lig = np.asarray(x_pred)[lig_idx]
    z = mol.atomic_numbers
    n = mol.num_atoms

    n_bond_viol = 0
    for i, j, o in mol.bonds:
        d = np.linalg.norm(lig[i] - lig[j])
        r0 = ideal_bond_length(int(z[i]), int(z[j]), o)
        if abs(d - r0) > bond_tol * r0:
            n_bond_viol += 1
    out["num_bond_violations"] = n_bond_viol
    out["bond_lengths_ok"] = n_bond_viol == 0

    # internal steric clash over the bond graph: pairs >= 3 bonds apart at
    # 0.7 x vdW contact, 1-4 pairs at 0.55 x (never the old vacuous 0.35 x)
    gd = _graph_distances(mol)
    vdw = np.array([_VDW.get(int(zz), 1.7) for zz in z])
    dmat = np.linalg.norm(lig[:, None] - lig[None], axis=-1)
    contact = vdw[:, None] + vdw[None, :]
    iu = np.triu_indices(n, k=1)
    sep = gd[iu]
    factor = np.where(sep == 3, 0.55, clash_factor)
    clash_pairs = (sep >= 3) & (dmat[iu] < factor * contact[iu])
    out["num_internal_clashes"] = int(np.sum(clash_pairs))
    out["no_internal_clash"] = out["num_internal_clashes"] == 0

    rec_sel = np.setdiff1d(np.arange(len(x_pred)), lig_idx)
    rec = np.asarray(x_pred)[rec_sel]
    if len(rec):
        d_lr = np.linalg.norm(lig[:, None] - rec[None], axis=-1)
        dmin = float(np.min(d_lr))
        names = meta.get("atom_names")
        if names is not None:
            rvdw = _receptor_vdw([names[i] for i in rec_sel])
        else:
            rvdw = np.full(len(rec), 1.7)
        pair_contact = vdw[:, None] + rvdw[None, :]
        # PoseBusters minimum_distance_to_protein: no ligand-receptor pair
        # inside 0.75 x vdW contact
        out["num_receptor_clashes"] = int(np.sum(d_lr < 0.75 * pair_contact))
        out["no_receptor_clash"] = out["num_receptor_clashes"] == 0
        # the ligand must touch the receptor (not float away) ...
        out["near_protein_ok"] = bool(dmin < 5.0)
        # ... and volume_overlap_with_protein <= 7.5% (approximated by the
        # fraction of ligand atoms buried inside a receptor atom's 0.5 x
        # vdW-contact shell — deep burial, i.e. genuine volume overlap)
        buried = float(np.mean(np.min(d_lr / pair_contact, axis=1) < 0.5))
        out["volume_overlap_ok"] = bool(buried <= 0.075)
    else:
        out["num_receptor_clashes"] = 0
        out["no_receptor_clash"] = True

    # bond angles: PoseBusters bounds each angle within [0.75, 1.25] x the
    # ideal value; the restraint builder records (a, centre, b, theta0)
    # from hybridization/ring membership
    rs = _cached_restraints(mol)
    n_angle_viol = 0
    for a, c, b, theta0 in rs.angles or []:
        va, vb = lig[a] - lig[c], lig[b] - lig[c]
        cosv = np.dot(va, vb) / (
            np.linalg.norm(va) * np.linalg.norm(vb) + 1e-9
        )
        theta = float(np.arccos(np.clip(cosv, -1.0, 1.0)))
        if not (0.75 * theta0 <= theta <= 1.25 * theta0):
            n_angle_viol += 1
    out["num_angle_violations"] = n_angle_viol
    out["bond_angles_ok"] = n_angle_viol == 0

    # E/Z double-bond stereo preserved (PoseBusters checks stereochemistry
    # beyond tetrahedral centres): the a-i-j-b dihedral must stay on the
    # annotated side (trans |phi| > 90 deg, cis < 90)
    n_ez_viol = 0
    for a, bi, bj, b, is_trans in getattr(mol, "stereo_bonds", None) or []:
        b1 = lig[bi] - lig[a]
        b2 = lig[bj] - lig[bi]
        b3 = lig[b] - lig[bj]
        n1 = np.cross(b1, b2)
        n2 = np.cross(b2, b3)
        cosphi = np.dot(n1, n2) / (
            np.linalg.norm(n1) * np.linalg.norm(n2) + 1e-9
        )
        if (cosphi < 0) != bool(is_trans):
            n_ez_viol += 1
    out["num_stereo_violations"] = n_ez_viol
    out["stereo_ez_ok"] = n_ez_viol == 0

    # aromatic ring flatness (PoseBusters threshold 0.25 A out-of-plane)
    arom = mol.aromatic_atoms()
    n_flat_viol = 0
    for ring in mol.rings():
        if len(ring) < 5 or not all(arom[a] for a in ring):
            continue
        pts = lig[ring] - lig[ring].mean(0)
        dev = np.linalg.svd(pts, compute_uv=False)[-1] / np.sqrt(len(ring))
        if dev > 0.25:
            n_flat_viol += 1
    out["num_aromatic_flatness_violations"] = n_flat_viol
    out["aromatic_flatness_ok"] = n_flat_viol == 0

    # double-bond flatness: the sp2 fragment (both atoms + their
    # neighbours) stays planar within 0.25 A
    n_db_viol = 0
    adj_l = mol.adjacency
    for i, j, o in mol.bonds:
        if o != 2.0 or arom[i] or arom[j]:
            continue
        frag = sorted({i, j, *adj_l[i], *adj_l[j]})
        if len(frag) < 4:
            continue
        pts = lig[frag] - lig[frag].mean(0)
        dev = np.linalg.svd(pts, compute_uv=False)[-1] / np.sqrt(len(frag))
        if dev > 0.25:
            n_db_viol += 1
    out["num_double_bond_flatness_violations"] = n_db_viol
    out["double_bond_flatness_ok"] = n_db_viol == 0

    try:
        import torch

        from physdock_tpu_torch.model.forcefield import (
            build_ligand_ff,
            chirality_correct,
            ff_energy,
        )

        ff = build_ligand_ff(
            z.tolist(), [(i, j) for i, j, _ in mol.bonds], mol.coords,
            chiral_centers=mol.chiral_centers(), device="cpu",
        )
        lig_t = torch.as_tensor(np.asarray(lig, np.float32))
        out["chirality_ok"] = bool(chirality_correct(lig_t[None], ff)[0])
        # internal energy (PoseBusters uses a 100x UFF-ensemble ratio; here
        # the restraint-field energy of the pose vs the reference conformer
        # plus a per-atom floor)
        e_pose = float(ff_energy(lig_t, ff))
        e_ref = float(ff_energy(torch.as_tensor(np.asarray(mol.coords, np.float32)), ff))
        out["internal_energy_ok"] = bool(
            e_pose <= 100.0 * max(e_ref, 0.1 * n)
        )
    except Exception:
        out["chirality_ok"] = True

    out["pose_valid"] = all(
        v for k, v in out.items() if k.endswith("_ok") or k.startswith("no_")
    )
    return out
