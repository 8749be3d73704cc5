"""Ligand restraint force field for physics guidance (port of
`physdock_tpu/model/forcefield.py`).

  E(x) = sum_bonds   k_b (|x_i - x_j| - r0)^2          r0 from the embedded conformer
       + sum_angles  k_a (d13 - d13_0)^2               1-3 distances (angle surrogate)
       + sum_planar  k_p (d14 - d14_0)^2               1-4 distances across sp2/rings
       + sum_nonbond k_nb relu(r_vdw - d)^2            one-sided vdW repulsion
       + sum_chiral  k_ch relu(m - s * vol)^2          signed-volume chirality wells

Arrays are padded to static sizes; `mask` entries zero padded terms.  The
relaxation's gradient is `torch.autograd.grad` of the energy (the JAX
package takes `jax.grad`).  `stack_ligand_ffs` stacks several ligands'
fields on a leading system axis; the energy, relaxation and chirality
check then take poses [Bsys, ..., L, 3], each system with its own field
(what `jax.vmap` over the stacked field gives the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Bondi-ish vdW radii (Angstrom) by atomic number; default 1.7.
_VDW_RADII = {
    1: 1.10, 5: 1.92, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.10, 15: 1.80,
    16: 1.80, 17: 1.75, 35: 1.85, 53: 1.98,
}


@dataclasses.dataclass(frozen=True)
class LigandFF:
    """Static-shaped restraint-field parameters for one ligand (tensors on
    the device the guidance runs on), or for several stacked on a leading
    system axis (`stack_ligand_ffs`)."""

    bond_idx: torch.Tensor  # [NB, 2] int64
    bond_r0: torch.Tensor  # [NB]
    bond_mask: torch.Tensor  # [NB]
    ang_idx: torch.Tensor  # [NA, 2] (1-3 pairs)
    ang_r0: torch.Tensor  # [NA]
    ang_mask: torch.Tensor  # [NA]
    tor_idx: torch.Tensor  # [NT, 2] (1-4 pairs, rigid ones only)
    tor_r0: torch.Tensor  # [NT]
    tor_mask: torch.Tensor  # [NT]
    nb_idx: torch.Tensor  # [NN, 2] (>=1-4 separated pairs)
    nb_r: torch.Tensor  # [NN] repulsion onset distance
    nb_mask: torch.Tensor  # [NN]
    chiral_idx: torch.Tensor  # [NC, 4]
    chiral_sign: torch.Tensor  # [NC] (+-1, sign of ref signed volume)
    chiral_mask: torch.Tensor  # [NC]


def _pad(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _round_up(n: int, m: int = 8) -> int:
    return max(m, ((n + m - 1) // m) * m)


def build_ligand_ff(
    atomic_numbers: Sequence[int],
    bonds: Sequence[Tuple[int, int]],
    ref_pos: np.ndarray,
    chiral_centers: Optional[Sequence[Tuple[int, Tuple[int, int, int, int]]]] = None,
    rigid_14: Optional[Sequence[Tuple[int, int]]] = None,
    device="cpu",
) -> LigandFF:
    """Host-side builder: derive restraint parameters from the molecular graph
    and an embedded reference conformer.

    chiral_centers: list of (center_atom, (n0, n1, n2, n3)) neighbour tuples
    in CIP-rank order; the target sign is measured on ref_pos.
    rigid_14: 1-4 pairs whose central bond is non-rotatable (rings, sp2).
    """
    n = len(atomic_numbers)
    ref_pos = np.asarray(ref_pos, np.float32)
    adj: List[set] = [set() for _ in range(n)]
    for i, j in bonds:
        adj[i].add(j)
        adj[j].add(i)

    def dist(i, j):
        return float(np.linalg.norm(ref_pos[i] - ref_pos[j]))

    bond_pairs = sorted({(min(i, j), max(i, j)) for i, j in bonds})
    bond_r0 = [dist(i, j) for i, j in bond_pairs]

    # 1-3 pairs through each centre atom
    ang_pairs = set()
    for c in range(n):
        nb = sorted(adj[c])
        for ii in range(len(nb)):
            for jj in range(ii + 1, len(nb)):
                ang_pairs.add((min(nb[ii], nb[jj]), max(nb[ii], nb[jj])))
    ang_pairs = sorted(ang_pairs - set(bond_pairs))
    ang_r0 = [dist(i, j) for i, j in ang_pairs]

    tor_pairs = sorted(set(rigid_14 or []) - set(bond_pairs) - set(ang_pairs))
    tor_r0 = [dist(i, j) for i, j in tor_pairs]

    # nonbonded: all pairs separated by >= 3 bonds (excl. rigid 1-4 restraints)
    excluded = set(bond_pairs) | set(ang_pairs) | set(tor_pairs)
    nb_pairs, nb_r = [], []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) in excluded:
                continue
            ri = _VDW_RADII.get(int(atomic_numbers[i]), 1.7)
            rj = _VDW_RADII.get(int(atomic_numbers[j]), 1.7)
            nb_pairs.append((i, j))
            nb_r.append(0.8 * (ri + rj))  # soft onset below 80% of contact

    ch_idx, ch_sign = [], []
    for centre, (a, b, c, d) in chiral_centers or []:
        v = np.dot(
            np.cross(ref_pos[b] - ref_pos[a], ref_pos[c] - ref_pos[a]),
            ref_pos[d] - ref_pos[a],
        )
        if abs(v) > 1e-3:
            ch_idx.append((a, b, c, d))
            ch_sign.append(np.sign(v))

    def t(a):
        return torch.as_tensor(a, device=device)

    def pack(pairs, r0, n_pad):
        idx = _pad(np.asarray(pairs, np.int64).reshape(-1, 2), n_pad)
        r = _pad(np.asarray(r0, np.float32), n_pad)
        m = _pad(np.ones(len(pairs), np.float32), n_pad)
        return t(idx), t(r), t(m)

    nb_b = _round_up(len(bond_pairs))
    nb_a = _round_up(len(ang_pairs))
    nb_t = _round_up(len(tor_pairs))
    nb_n = _round_up(len(nb_pairs))
    nb_c = _round_up(len(ch_idx)) if ch_idx else 8

    b_i, b_r, b_m = pack(bond_pairs or [(0, 0)], bond_r0 or [0.0], nb_b)
    a_i, a_r, a_m = pack(ang_pairs or [(0, 0)], ang_r0 or [0.0], nb_a)
    t_i, t_r, t_m = pack(tor_pairs or [(0, 0)], tor_r0 or [0.0], nb_t)
    n_i, n_r, n_m = pack(nb_pairs or [(0, 0)], nb_r or [0.0], nb_n)
    if not bond_pairs:
        b_m = torch.zeros_like(b_m)
    if not ang_pairs:
        a_m = torch.zeros_like(a_m)
    if not tor_pairs:
        t_m = torch.zeros_like(t_m)
    if not nb_pairs:
        n_m = torch.zeros_like(n_m)

    c_i = t(_pad(np.asarray(ch_idx or [(0, 0, 0, 0)], np.int64).reshape(-1, 4), nb_c))
    c_s = t(_pad(np.asarray(ch_sign or [0.0], np.float32), nb_c))
    c_m = t(_pad(np.ones(len(ch_idx), np.float32), nb_c))

    return LigandFF(
        bond_idx=b_i, bond_r0=b_r, bond_mask=b_m,
        ang_idx=a_i, ang_r0=a_r, ang_mask=a_m,
        tor_idx=t_i, tor_r0=t_r, tor_mask=t_m,
        nb_idx=n_i, nb_r=n_r, nb_mask=n_m,
        chiral_idx=c_i, chiral_sign=c_s, chiral_mask=c_m,
    )


def stack_ligand_ffs(ffs: Sequence[LigandFF]) -> LigandFF:
    """Stack per-ligand force fields on a leading system axis, every term
    padded to the largest capacity of the batch (zero masks on the
    padding)."""

    def pad_stack(field: str) -> torch.Tensor:
        arrs = [getattr(f, field) for f in ffs]
        n = max(a.shape[0] for a in arrs)
        return torch.stack([torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])
                            for a in arrs])

    return LigandFF(**{f.name: pad_stack(f.name) for f in dataclasses.fields(LigandFF)})


K_BOND = 100.0
K_ANG = 50.0
K_TOR = 10.0
K_NB = 25.0
K_CHIRAL = 50.0
CHIRAL_MARGIN = 0.5


def _per_system(t, pos):
    """A stacked field [Bsys, K] viewed as [Bsys, 1, ..., K] to broadcast
    against per-pose values [Bsys, ..., K] of poses `pos` [Bsys, ..., L, 3];
    an unstacked field as it is."""
    if t.dim() == 1:
        return t
    return t.view(t.shape[:1] + (1,) * (pos.dim() - 3) + t.shape[1:])


def _atoms(pos, idx):
    """pos[..., idx, :]: [..., K, 3] for idx [K], or per system for a
    stacked idx [Bsys, K] and pos [Bsys, ..., L, 3]."""
    if idx.dim() == 1:
        return pos[..., idx, :]
    idx = _per_system(idx, pos)[..., None]
    return torch.gather(pos, -2, idx.expand(*pos.shape[:-2], idx.shape[-2], 3))


def _chiral_volumes(pos, idx):
    a, b, c, d = (_atoms(pos, idx[..., j]) for j in range(4))
    return torch.sum(torch.linalg.cross(b - a, c - a, dim=-1) * (d - a), dim=-1)


def ff_energy(pos: torch.Tensor, ff: LigandFF) -> torch.Tensor:
    """Restraint energy per pose. pos: [..., L, 3] -> [...], or with a
    stacked field [Bsys, ..., L, 3] -> [Bsys, ...]."""

    def pair_term(idx, r0, mask, k, one_sided=False):
        d = torch.linalg.norm(_atoms(pos, idx[..., 0]) - _atoms(pos, idx[..., 1]) + 1e-9, dim=-1)
        r0 = _per_system(r0, pos)
        diff = torch.relu(r0 - d) if one_sided else d - r0
        return k * torch.sum(_per_system(mask, pos) * diff * diff, dim=-1)

    e = pair_term(ff.bond_idx, ff.bond_r0, ff.bond_mask, K_BOND)
    e = e + pair_term(ff.ang_idx, ff.ang_r0, ff.ang_mask, K_ANG)
    e = e + pair_term(ff.tor_idx, ff.tor_r0, ff.tor_mask, K_TOR)
    e = e + pair_term(ff.nb_idx, ff.nb_r, ff.nb_mask, K_NB, one_sided=True)
    vol = _chiral_volumes(pos, ff.chiral_idx)
    viol = torch.relu(CHIRAL_MARGIN - _per_system(ff.chiral_sign, pos) * vol)
    return e + K_CHIRAL * torch.sum(_per_system(ff.chiral_mask, pos) * viol * viol, dim=-1)


def relax_positions(pos: torch.Tensor, ff: LigandFF, iters: int = 5,
                    step_size: float = 2e-3, max_step: float = 0.2) -> torch.Tensor:
    """Fixed-iteration gradient minimization of the restraint field, steps
    norm-clipped per atom. pos: [..., L, 3] ([Bsys, ..., L, 3] with a
    stacked field); poses relax independently."""
    p = pos.detach().float()
    with torch.enable_grad():
        for _ in range(iters):
            x = p.requires_grad_(True)
            (g,) = torch.autograd.grad(ff_energy(x, ff).sum(), x)
            step = step_size * g
            norm = torch.linalg.norm(step, dim=-1, keepdim=True)
            step = step * torch.clamp(max_step / (norm + 1e-9), max=1.0)
            p = (x - step).detach()
    return p


def chirality_correct(pos: torch.Tensor, ff: LigandFF) -> torch.Tensor:
    """True where every chiral centre's signed volume matches the
    reference sign. pos: [..., L, 3] -> [...] bool (with a stacked field
    [Bsys, ..., L, 3] -> [Bsys, ...])."""
    vol = _chiral_volumes(pos, ff.chiral_idx)
    ok = (vol * _per_system(ff.chiral_sign, pos) > 0) | (_per_system(ff.chiral_mask, pos) == 0)
    return torch.all(ok, dim=-1)
