"""Plain reference of one PhysDock training step: the keyed draws of the
EDM noise, the forward of `perfbench/reference/physdock.py` on the noised
copies, the release loss (rigid-aligned EDM-weighted MSE, smooth lDDT,
distogram cross entropy; the bond and key-residue terms have weight 0),
its gradient by autograd, the per-system clip to 0.1, the global clip to
10 and Adam (b1 0.9, b2 0.95, eps 1e-8; lr 1.8e-3 x (step + 1) / 1000 in
warm-up).

Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from perfbench.reference import physdock as ref

PURPOSE_FORWARD = 0


def _stream(seed: int, step: int, index: int) -> torch.Generator:
    """The CPU generator of system `index`'s forward draws in step `step`
    (NumPy's SeedSequence of (seed, step, index, 0) as its 64-bit seed)."""
    s = np.random.SeedSequence([seed, step, index, PURPOSE_FORWARD]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(s[0]))


def _rotations(n: int, gen: torch.Generator) -> torch.Tensor:
    """n uniform random rotations (rows e0, e1, e2): Gram-Schmidt on two
    uniform points of the sphere."""

    def sphere():
        phi = torch.rand((n,), generator=gen) * 2 * np.pi
        theta = torch.arccos(torch.rand((n,), generator=gen) * 2 - 1)
        return torch.stack([torch.cos(phi) * torch.sin(theta), torch.sin(phi) * torch.sin(theta),
                            torch.cos(theta)], -1)

    e0, u1 = sphere(), sphere()
    e1 = u1 - e0 * (u1 * e0).sum(-1, keepdim=True)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    return torch.stack([e0, e1, torch.linalg.cross(e0, e1, dim=-1)], -2)


def draws(x_gt: torch.Tensor, x_exists: torch.Tensor, n: int, sigma_data: float, seed: int,
          step: int, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_hat [n, A, 3], t_hat [n]): n copies of x_gt noised at
    sigma ~ exp(N(-1.2, 1.5^2)) sigma_data, centred, rotated and shifted."""
    gen = _stream(seed, step, index)
    t_hat = torch.exp(torch.randn(n, generator=gen) * 1.5 - 1.2) * sigma_data
    noise = torch.randn((n,) + tuple(x_gt.shape), generator=gen, dtype=x_gt.dtype)
    rot = _rotations(n, gen)
    trans = torch.randn((n, 3), generator=gen, dtype=x_gt.dtype)
    dev = x_gt.device
    t_hat = t_hat.to(dev)
    x = x_gt[None] + noise.to(dev) * t_hat[:, None, None]
    w = x_exists.to(x.dtype)
    mean = (x * w[:, None]).sum(-2, keepdim=True) / w.sum()
    x = torch.einsum("nij,nkj->nki", rot.to(dev, x.dtype), x - mean) + trans.to(dev)[:, None]
    return x, t_hat


def _kabsch_onto(x_pred, x_gt, w):
    """x_gt placed onto x_pred [N, A, 3] by the weighted least-squares rigid
    fit (no gradient), reflections excluded."""
    with torch.no_grad():
        x_pred, x_gt = x_pred.float(), x_gt.float()
        ww = w[None, :, None]
        den = w.sum()
        mp = (x_pred * ww).sum(-2) / den
        mg = (x_gt[None] * ww).sum(-2) / den
        p, g = x_pred - mp[:, None], x_gt[None] - mg[:, None]
        H = torch.einsum("nij,nik->njk", g * ww, p)
        U, _, Vh = torch.linalg.svd(H)
        R = U @ Vh
        flip = torch.diag(torch.tensor([1.0, 1.0, -1.0], device=H.device))
        R = torch.where((torch.linalg.det(R) < 0)[:, None, None], U @ flip @ Vh, R)
        return torch.einsum("nij,nkj->nki", R.transpose(-1, -2), g) + mp[:, None]


def _eps4(d):
    return 0.25 * sum(torch.sigmoid(d - c) for c in (0.5, 1.0, 2.0, 4.0))


def _mmean(mask, v, dims):
    mask = torch.broadcast_to(mask, v.shape)
    return (mask * v).sum(dims) / (1e-9 + mask.sum(dims))


def loss(c: Dict, b: Dict[str, torch.Tensor], x_den, x_hat, t_hat, p_dist) -> torch.Tensor:
    """The release loss of one system: 4 (weighted MSE + smooth lDDT) +
    0.03 distogram cross entropy (terms that are not finite count 0)."""
    sd = c["sigma_data"]
    x_gt, ex = b["x_gt"].float(), b["x_exists"].float()
    tok_w = 1.0 + 5.0 * b["is_dna"] + 5.0 * b["is_rna"] + 10.0 * b["is_ligand"]
    w = tok_w.float().index_select(-1, b["atom_id_to_token_id"].long()) * ex
    aligned = _kabsch_onto(x_den * ex[..., None], x_gt, w)
    sq = ((x_den - aligned) ** 2).sum(-1)
    lam = (t_hat ** 2 + sd ** 2) / (t_hat * sd) ** 2 / 3.0
    mse = torch.clamp((lam * _mmean(w[None], sq, (-1, -2))).mean(), max=1e4)

    def norm(x):
        return torch.linalg.norm(x + 1e-12, dim=-1)

    d_pred = norm(x_den[..., None, :] - x_den[..., None, :, :])
    d_gt = norm(x_gt[..., None, :] - x_gt[None, :, :])
    m = (d_gt < 15.0) * ex[:, None] * ex[None, :]
    lddt = _mmean(m[None], _eps4((d_pred - d_gt[None]).abs()), (-1, -2)).mean()

    pb = b["token_id_to_pseudo_beta_atom_id"].long()
    xb, e = x_gt.index_select(-2, pb), ex.index_select(-1, pb)
    pm = e[:, None] * e[None, :]
    edges = torch.linspace(3.25, 50.75, 38, device=x_gt.device) ** 2
    d2 = ((xb[:, None] - xb[None, :]) ** 2).sum(-1, keepdim=True)
    labels = F.one_hot((d2 > edges).sum(-1), 39).float() * pm[..., None]
    ce = -(labels * F.log_softmax(p_dist * pm[..., None], dim=-1)).sum(-1)
    dist = _mmean(pm, ce, (-1, -2))

    total = 0.0
    for weight, v in ((4.0, mse), (4.0, lddt), (0.03, dist)):
        total = total + weight * torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    return total


def forward_loss(R: ref.Ref, c: Dict, batch: Dict[str, torch.Tensor], x_hat, t_hat,
                 chunk: int) -> torch.Tensor:
    """The loss of one system given its noised copies; the denoiser runs
    in chunks of poses, each (and each block) recomputed in the backward
    pass."""
    b = ref.expand_features(batch)
    a, ap, s, z = ref.conditioning(R, c, b)
    sd = c["sigma_data"]

    def den(x, t, a, ap, s, z):
        r = ref.denoise(R, c, b, x, t, a, ap, s, z)
        skip = sd ** 2 / (sd ** 2 + t ** 2)
        out = sd * t / torch.sqrt(sd ** 2 + t ** 2)
        return skip[:, None, None] * x + out[:, None, None] * r

    x_den = torch.cat([R.block(den, x_hat[i:i + chunk], t_hat[i:i + chunk], a, ap, s, z)
                       for i in range(0, x_hat.shape[0], chunk)])
    p = R.lin("linear_distogram", z)
    return loss(c, b, x_den, x_hat, t_hat, p + p.transpose(-2, -3))


def _global_norm(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((t.double() ** 2).sum() for t in ts))


def train_steps(c: Dict, W0: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
                prec: str, seed: int, n_aug: int, chunk: int = 8, start: int = 0,
                mu0: Optional[Dict[str, torch.Tensor]] = None,
                nu0: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """One step a batch (one system a step) from the weights W0, the first
    being update `start` with Adam's moments `mu0`, `nu0` (zero where not
    given). Returns each step's loss, the first step's gradient per leaf
    as Adam receives it, and each leaf's parameters after the steps."""
    P = ref.Prec(prec)
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) if mu0 is None else mu0[k].clone() for k, v in params.items()}
    nu = {k: torch.zeros_like(v) if nu0 is None else nu0[k].clone() for k, v in params.items()}
    losses, first = [], None
    for step, batch in enumerate(batches, start):
        R = ref.Ref(params, P, remat=True)
        x_hat, t_hat = draws(batch["x_gt"].float(), batch["x_exists"].float(), n_aug,
                             c["sigma_data"], seed, step, 0)
        lv = forward_loss(R, c, batch, x_hat, t_hat, chunk)
        names = list(params)
        grads = torch.autograd.grad(lv, [params[k] for k in names], allow_unused=True)
        g = [torch.zeros_like(params[k]) if gi is None else gi.float()
             for k, gi in zip(names, grads)]
        scale = min(1.0, 0.1 / (float(_global_norm(g)) + 1e-9))  # per system
        g = [x * scale for x in g]
        gn = float(_global_norm(g))
        if gn >= 10.0:
            g = [x * (10.0 / gn) for x in g]
        if first is None:
            first = {k: x.detach().clone() for k, x in zip(names, g)}
        lr = 1.8e-3 * min((step + 1) / 1000.0, 1.0)
        bc1, bc2 = 1 - 0.9 ** (step + 1), 1 - 0.95 ** (step + 1)
        with torch.no_grad():
            for k, gi in zip(names, g):
                mu[k].mul_(0.9).add_(gi, alpha=0.1)
                nu[k].mul_(0.95).add_(gi * gi, alpha=0.05)
                params[k].add_(-lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8))
        losses.append(float(lv.detach()))
        del lv, grads, g
    return {"losses": losses, "grad": first, "params": {k: v.detach() for k, v in params.items()}}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap |got - want| of a per-leaf norm, over the larger
    of the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[k] for k in keep]))
    worst, name = 0.0, ""
    for k in keep:
        gap = abs(got[k] - want[k]) / max(want[k], med)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tree.items()}


def moved(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(after[k].detach().double() - before[k].double()))
            for k in after}
