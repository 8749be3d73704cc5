#!/usr/bin/env python3
"""The guided sampler's force-field relaxation (`model/forcefield.py`) on
one CUDA card, with three ways of looking up the atoms each term reads:
`torch.gather` per term (its gradient is an atomic scatter_add), indexing
per term (an ordered accumulation per term), and one indexing lookup for
every term (`ff_energy` as it is).  For the EJQ demo ligand as a stacked
field of one system and 20 noisy poses: the seconds of 80 relaxations of
5 iterations (one dock's 2 rounds of 40 steps), twice per variant, and
whether three relaxations of 20 iterations are bit-identical.

    python3 scripts/torch_ff_lookup_ab.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from physdock_tpu_torch.data.mol import read_sdf  # noqa: E402
from physdock_tpu_torch.model import forcefield as ff_mod  # noqa: E402


def gather_atoms(p, idx):
    """The lookup by `torch.gather` (atomic gradient)."""
    if idx.dim() == 1:
        return p[..., idx, :]
    idx = ff_mod._per_system(idx, p)[..., None]
    return torch.gather(p, -2, idx.expand(*p.shape[:-2], idx.shape[-2], 3))


def energy_per_term(p, f, atoms):
    """ff_energy with one lookup per term through `atoms`."""
    def pair_term(idx, r0, mask, k, one_sided=False):
        d = torch.linalg.norm(atoms(p, idx[..., 0]) - atoms(p, idx[..., 1]) + 1e-9, dim=-1)
        r0 = ff_mod._per_system(r0, p)
        diff = torch.relu(r0 - d) if one_sided else d - r0
        return k * torch.sum(ff_mod._per_system(mask, p) * diff * diff, dim=-1)

    e = pair_term(f.bond_idx, f.bond_r0, f.bond_mask, ff_mod.K_BOND)
    e = e + pair_term(f.ang_idx, f.ang_r0, f.ang_mask, ff_mod.K_ANG)
    e = e + pair_term(f.tor_idx, f.tor_r0, f.tor_mask, ff_mod.K_TOR)
    e = e + pair_term(f.nb_idx, f.nb_r, f.nb_mask, ff_mod.K_NB, one_sided=True)
    vol = ff_mod._signed_volume(*(atoms(p, f.chiral_idx[..., j]) for j in range(4)))
    viol = torch.relu(ff_mod.CHIRAL_MARGIN - ff_mod._per_system(f.chiral_sign, p) * vol)
    return e + ff_mod.K_CHIRAL * torch.sum(ff_mod._per_system(f.chiral_mask, p) * viol * viol,
                                           dim=-1)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_ff_lookup_ab: needs a CUDA card")
    mol = read_sdf("demo/system_preparation/EJQ.sdf")
    ff = ff_mod.stack_ligand_ffs([ff_mod.build_ligand_ff(
        mol.atomic_numbers.tolist(), [(i, j) for i, j, _ in mol.bonds], mol.coords,
        chiral_centers=mol.chiral_centers(), device="cuda")])
    rng = np.random.default_rng(0)
    noisy = mol.coords[None, None] + rng.normal(size=(1, 20) + mol.coords.shape)
    pos = torch.from_numpy(noisy.astype(np.float32)).cuda()
    one_lookup = ff_mod.ff_energy
    variants = {
        "gather per term": lambda p, f: energy_per_term(p, f, gather_atoms),
        "index per term": lambda p, f: energy_per_term(p, f, ff_mod._atoms),
        "one index lookup (ff_energy)": one_lookup,
    }
    print(f"{torch.cuda.get_device_name(0)}: L {mol.num_atoms}, "
          f"{int(ff.nb_mask.sum())} non-bonded pairs", flush=True)
    try:
        for _ in range(2):
            for name, fn in variants.items():
                ff_mod.ff_energy = fn
                torch.cuda.synchronize()
                t0 = time.time()
                for _ in range(80):
                    ff_mod.relax_positions(pos, ff, iters=5)
                torch.cuda.synchronize()
                dt = time.time() - t0
                outs = [ff_mod.relax_positions(pos, ff, iters=20) for _ in range(3)]
                same = all(torch.equal(o, outs[0]) for o in outs)
                print(f"{name}: {dt:.3f} s per 80 relaxations of 5 iterations; "
                      f"bit-identical repeats {same}", flush=True)
    finally:
        ff_mod.ff_energy = one_lookup


if __name__ == "__main__":
    main()
