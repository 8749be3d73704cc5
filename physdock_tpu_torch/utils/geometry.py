"""Geometry and tensor primitives (port of `physdock_tpu/utils/geometry.py`).

Torch versions of the device-side helpers the redocking path uses; the
NumPy twins the host featurizer needs live in `utils/geometry_np.py`
(no torch, for the featurizer worker) and are re-exported here.
Randomness comes from an explicit `torch.Generator` or
`np.random.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from physdock_tpu_torch.utils.geometry_np import (  # noqa: F401
    random_rigid_transform_np,
    uniform_random_rotation_np,
)


def masked_mean(mask, value, dim, eps: float = 1e-9):
    """Mean of `value` over `dim` weighted by broadcastable `mask`."""
    mask = torch.broadcast_to(mask, value.shape)
    return torch.sum(mask * value, dim=dim) / (eps + torch.sum(mask, dim=dim))


def take_rows(x, idx, dim: int = -2):
    """x's entries at `idx` along `dim` (-1 or -2). idx [T] is taken
    for every leading index of x; idx [..., T] gives each entry of its
    own leading axes, which match x's last batch axes (a system axis),
    its own rows."""
    if idx.dim() == 1:
        return torch.index_select(x, dim, idx)
    if dim == -1:
        return torch.gather(x, -1, idx.expand(*x.shape[:-1], idx.shape[-1]))
    idx = idx[..., None]
    return torch.gather(x, -2, idx.expand(*x.shape[:-2], idx.shape[-2], x.shape[-1]))


def one_hot_nearest(x, v_bins):
    """One-hot of the nearest bin (AF3 Algorithm 4)."""
    diffs = x[..., None] - v_bins.reshape((1,) * x.dim() + (-1,))
    am = torch.argmin(torch.abs(diffs), dim=-1)
    return torch.nn.functional.one_hot(am, v_bins.shape[-1]).float()


def gen_attn_mask(mask, neg_inf: float):
    """Additive attention mask: 0 where mask != 0, neg_inf elsewhere."""
    return torch.where(
        mask == 0,
        torch.tensor(neg_inf, dtype=mask.dtype, device=mask.device),
        torch.zeros((), dtype=mask.dtype, device=mask.device),
    )


def uniform_random_rotation(shape: Tuple[int, ...], generator: Optional[torch.Generator], device):
    """Uniform random rotations [*shape, 3, 3] (rows e0, e1, e2) by
    Gram-Schmidt on two uniform sphere points."""

    def sphere():
        phi = torch.rand(shape, generator=generator, device=device) * 2 * np.pi
        theta = torch.arccos(torch.rand(shape, generator=generator, device=device) * 2 - 1)
        return torch.stack(
            [torch.cos(phi) * torch.sin(theta), torch.sin(phi) * torch.sin(theta), torch.cos(theta)],
            dim=-1,
        )

    e0 = sphere()
    u1 = sphere()
    e1 = u1 - e0 * torch.sum(u1 * e0, dim=-1, keepdim=True)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(e0, e1, dim=-1)
    return torch.stack([e0, e1, e2], dim=-2)


def centre_random_augmentation(x, x_exists, generator: Optional[torch.Generator] = None, s: float = 1.0):
    """Centre on the masked mean, rotate each leading batch element at
    random and add N(0, s) translation. x: [..., A, 3]; x_exists: [A],
    or [Bsys, 1, A] for poses [Bsys, N, A, 3] of several systems."""
    rot = uniform_random_rotation(tuple(x.shape[:-2]), generator, x.device)
    t = s * torch.randn(tuple(x.shape[:-2]) + (3,), generator=generator, device=x.device, dtype=x.dtype)
    return apply_centre_augmentation(x, x_exists, rot, t)


def apply_centre_augmentation(x, x_exists, rot, t):
    """Deterministic body of `centre_random_augmentation` with explicit
    rotation/translation (the lockstep-parity injection point)."""
    w = x_exists.to(x.dtype)
    mean = torch.sum(x * w[..., :, None], dim=-2, keepdim=True) / w.sum(-1)[..., None, None]
    x_aug = torch.einsum("...ij,...kj->...ki", rot.to(x.dtype), x - mean)
    return x_aug + t[..., None, :].to(x.dtype)


def weighted_rigid_align(x_pred, x_gt, weights):
    """Weighted Kabsch alignment (AF3 Algorithm 28): returns x_gt placed in
    x_pred's pose. SVD in fp32 with the reflection fix; no gradient.

    x_pred: [..., S, A, 3], x_gt: [..., A, 3] or [..., S, A, 3],
    weights: [..., A]."""
    with torch.no_grad():
        in_dtype = x_pred.dtype
        x_pred = x_pred.float()
        x_gt = x_gt.float()
        weights = weights.float()
        if x_gt.dim() == x_pred.dim() - 1:
            x_gt = x_gt[..., None, :, :]

        w = weights[..., None, :, None]
        denom = torch.sum(weights[..., None, :], dim=-1, keepdim=True)
        mu_pred = torch.sum(x_pred * w, dim=-2) / denom
        mu_gt = torch.sum(x_gt * w, dim=-2) / denom

        x_pred_hat = x_pred - mu_pred[..., None, :]
        x_gt_hat = x_gt - mu_gt[..., None, :]

        H = torch.einsum("...ij,...ik->...jk", x_gt_hat * w, x_pred_hat)
        U, _, Vh = torch.linalg.svd(H, full_matrices=False)
        flip = torch.diag(torch.tensor([1.0, 1.0, -1.0], device=H.device))
        R = U @ Vh
        R_reflect = U @ flip @ Vh
        reflected = torch.linalg.det(R) < 0
        R = torch.where(reflected[..., None, None], R_reflect, R)
        R = R.transpose(-1, -2)

        aligned = torch.einsum("...ij,...kj->...ki", R, x_gt_hat) + mu_pred[..., None, :]
        return aligned.to(in_dtype)


def smooth_lddt_epsilon(delta):
    """The 4-sigmoid soft-lDDT penalty used by physics guidance."""
    return 0.25 * (
        torch.sigmoid(delta - 0.5)
        + torch.sigmoid(delta - 1.0)
        + torch.sigmoid(delta - 2.0)
        + torch.sigmoid(delta - 4.0)
    )


def signed_volume(p0, p1, p2, p3):
    """Signed volume of the tetrahedron spanned by four points."""
    return torch.sum(torch.linalg.cross(p1 - p0, p2 - p0, dim=-1) * (p3 - p0), dim=-1)
