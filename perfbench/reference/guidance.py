"""Plain reference of the sampler's physics-guidance projection at low
noise: the ligand's restraint field (bonds, 1-3 and rigid 1-4 distances,
one-sided van der Waals repulsion, signed-volume chirality wells, each
from the embedded reference conformer), five norm-clipped gradient steps
on it, and the weighted Kabsch alignment (AF3 Algorithm 28) of the relaxed
ligand onto the denoised one.

Imports only numpy and torch. The gradient is written out by hand, so the
reference does not share the measured program's autograd path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from perfbench.reference.physdock import Prec

_VDW = {1: 1.10, 5: 1.92, 6: 1.70, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.10, 15: 1.80,
        16: 1.80, 17: 1.75, 35: 1.85, 53: 1.98}
K_BOND, K_ANG, K_TOR, K_NB, K_CHIRAL, MARGIN = 100.0, 50.0, 10.0, 25.0, 50.0, 0.5


def build_field(atomic_numbers: Sequence[int], bonds: Sequence[Tuple[int, int]],
                ref_pos: np.ndarray, chiral: Sequence, rigid_14: Sequence[Tuple[int, int]]):
    """The restraint terms as index and target arrays: {"pairs": [(idx [K,
    2], r0 [K], k, one_sided)], "chiral": (idx [C, 4], sign [C])}."""
    n = len(atomic_numbers)
    ref = np.asarray(ref_pos, np.float64)
    adj = [set() for _ in range(n)]
    for i, j in bonds:
        adj[i].add(j)
        adj[j].add(i)
    bond = sorted({(min(i, j), max(i, j)) for i, j in bonds})
    ang = set()
    for c in range(n):
        nb = sorted(adj[c])
        ang |= {(min(a, b), max(a, b)) for x, a in enumerate(nb) for b in nb[x + 1:]}
    ang = sorted(ang - set(bond))
    tor = sorted(set(rigid_14) - set(bond) - set(ang))
    excl = set(bond) | set(ang) | set(tor)
    nonb = [(i, j) for i in range(n) for j in range(i + 1, n) if (i, j) not in excl]
    vdw = [0.8 * (_VDW.get(int(atomic_numbers[i]), 1.7) + _VDW.get(int(atomic_numbers[j]), 1.7))
           for i, j in nonb]

    def dist(pairs):
        return [float(np.linalg.norm(ref[i] - ref[j])) for i, j in pairs]

    pairs = [(bond, dist(bond), K_BOND, False), (ang, dist(ang), K_ANG, False),
             (tor, dist(tor), K_TOR, False), (nonb, vdw, K_NB, True)]
    ch_idx, ch_sign = [], []
    for _, (a, b, c, d) in chiral:
        v = np.dot(np.cross(ref[b] - ref[a], ref[c] - ref[a]), ref[d] - ref[a])
        if abs(v) > 1e-3:
            ch_idx.append((a, b, c, d))
            ch_sign.append(float(np.sign(v)))
    return {"pairs": [(np.asarray(p, np.int64).reshape(-1, 2), np.asarray(r, np.float64), k, o)
                      for p, r, k, o in pairs if len(p)],
            "chiral": (np.asarray(ch_idx, np.int64).reshape(-1, 4),
                       np.asarray(ch_sign, np.float64))}


def _grad(x: torch.Tensor, field) -> torch.Tensor:
    """d E / d x of the restraint energy, poses x [..., L, 3]."""
    g = torch.zeros_like(x)
    for idx, r0, k, one_sided in field["pairs"]:
        i, j = torch.as_tensor(idx[:, 0], device=x.device), torch.as_tensor(idx[:, 1], device=x.device)
        diff = x[..., i, :] - x[..., j, :] + 1e-9
        d = torch.linalg.norm(diff, dim=-1)
        r = torch.as_tensor(r0, dtype=x.dtype, device=x.device)
        e = torch.relu(r - d) if one_sided else d - r
        # E = k e^2; dE/dd = 2 k e * (de/dd), de/dd = -1 where the one-sided term acts
        dd = 2 * k * e * (-(r > d).to(x.dtype) if one_sided else 1.0)
        f = dd[..., None] * diff / d[..., None]
        g.index_add_(-2, i, f)
        g.index_add_(-2, j, -f)
    idx, sign = field["chiral"]
    if len(idx):
        ix = [torch.as_tensor(idx[:, c], device=x.device) for c in range(4)]
        a, b, c, d = (x[..., t, :] for t in ix)
        u, v, w = b - a, c - a, d - a
        vol = torch.sum(torch.linalg.cross(u, v, dim=-1) * w, dim=-1)
        s = torch.as_tensor(sign, dtype=x.dtype, device=x.device)
        viol = torch.relu(MARGIN - s * vol)
        dvol = 2 * K_CHIRAL * viol * (-s) * (viol > 0).to(x.dtype)
        gb = torch.linalg.cross(v, w, dim=-1)
        gc = torch.linalg.cross(w, u, dim=-1)
        gd = torch.linalg.cross(u, v, dim=-1)
        for t, gt in ((ix[1], gb), (ix[2], gc), (ix[3], gd), (ix[0], -(gb + gc + gd))):
            g.index_add_(-2, t, dvol[..., None] * gt)
    return g


def relax(pos: torch.Tensor, field, iters: int = 5, step_size: float = 2e-3,
          max_step: float = 0.2) -> torch.Tensor:
    """Fixed-step gradient descent on the field, each atom's step clipped
    to `max_step`."""
    p = pos.float()
    for _ in range(iters):
        step = step_size * _grad(p, field)
        norm = torch.linalg.norm(step, dim=-1, keepdim=True)
        p = p - step * torch.clamp(max_step / (norm + 1e-9), max=1.0)
    return p


def kabsch_place(P: Prec, moving: torch.Tensor, onto: torch.Tensor) -> torch.Tensor:
    """`moving` [..., L, 3] rotated and translated onto `onto` [..., L, 3]
    by the least-squares rigid fit with unit weights, reflections
    excluded."""
    mu_m, mu_o = moving.mean(-2, keepdim=True), onto.mean(-2, keepdim=True)
    m, o = moving - mu_m, onto - mu_o
    H = P.ein("...ij,...ik->...jk", m, o)
    U, _, Vh = torch.linalg.svd(H)
    R = U @ Vh
    flip = torch.diag(torch.tensor([1.0, 1.0, -1.0], device=H.device))
    R = torch.where((torch.linalg.det(R) < 0)[..., None, None], U @ flip @ Vh, R)
    return P.ein("...ij,...kj->...ki", R.transpose(-1, -2), m) + mu_o
