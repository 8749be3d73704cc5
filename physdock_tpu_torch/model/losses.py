"""Training losses (port of `physdock_tpu/model/losses.py`).

`physdock_loss` is the aggregate of the reference's PhysDockLoss
(loss.py:576-624): rigid-aligned weighted MSE, smooth lDDT, bond and
key-residue terms (both EDM-weighted) and the distogram cross entropy,
each zeroed where it is not finite.  `rffold_loss` is the training-era
aggregate: that set plus, under the mini-rollout, the binned pLDDT, PAE
and PDE cross entropies of the confidence head (`plddt_loss`, `pae_loss`,
`pde_loss`), their labels computed from the rollout's pose without
gradient.  The frame-aligned `fape_loss` is not ported: no aggregate
reaches it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from physdock_tpu_torch.config import LossConfig
from physdock_tpu_torch.utils.geometry import (
    masked_mean,
    smooth_lddt_epsilon,
    weighted_rigid_align,
)

Batch = Dict[str, torch.Tensor]


def _norm(x):
    """Euclidean norm over the last axis, with the +1e-12 the JAX losses
    add inside it so that the gradient is finite at coincident points."""
    return torch.linalg.norm(x + 1e-12, dim=-1)


def _centres(x, token_id_to_centre_atom_id):
    return x.index_select(-2, token_id_to_centre_atom_id)


def _edm_weight(t_hat, sigma_data):
    return (t_hat**2 + sigma_data**2) / (t_hat * sigma_data) ** 2


def softmax_cross_entropy(logits, labels):
    return -torch.sum(labels * F.log_softmax(logits, dim=-1), dim=-1)


def weighted_mse_loss(x_denoised, x_gt, t_hat, *, sigma_data, is_dna, is_rna, is_ligand,
                      alpha_dna, alpha_rna, alpha_ligand, atom_id_to_token_id, x_exists):
    """Rigid-aligned EDM-weighted MSE (loss.py:120-163); clamped at 1e4."""
    tok_w = 1.0 + is_dna * alpha_dna + is_rna * alpha_rna + is_ligand * alpha_ligand
    weights = tok_w.index_select(-1, atom_id_to_token_id) * x_exists
    x_gt_aligned = weighted_rigid_align(x_denoised * x_exists[..., None], x_gt, weights)
    sq = torch.sum((x_denoised - x_gt_aligned) ** 2, dim=-1)
    lam = _edm_weight(t_hat, sigma_data) / 3.0
    loss = lam * masked_mean(weights[..., None, :], sq, dim=(-1, -2))
    return torch.clamp(torch.mean(loss), max=1e4)


def smooth_lddt_loss(x_denoised, x_gt, x_exists, *, max_clamp_distance: float = 15.0):
    """4-sigmoid soft lDDT on pair distances below the clamp (loss.py:166-186)."""
    d_pred = _norm(x_denoised[..., None, :] - x_denoised[..., None, :, :])
    d_gt = _norm(x_gt[..., None, :] - x_gt[..., None, :, :])
    mask = ((d_gt < max_clamp_distance) * x_exists[..., None] * x_exists[..., None, :])
    eps = smooth_lddt_epsilon(torch.abs(d_pred - d_gt[..., None, :, :]))
    return torch.mean(masked_mean(mask[..., None, :, :], eps, dim=(-1, -2)))


def _centre_distances(x_denoised, x_gt, token_id_to_centre_atom_id):
    xc_pred = _centres(x_denoised, token_id_to_centre_atom_id)
    xc_gt = _centres(x_gt, token_id_to_centre_atom_id)
    d_pred = _norm(xc_pred[..., None, :, :] - xc_pred[..., :, None, :])
    d_gt = _norm(xc_gt[..., None, :, :] - xc_gt[..., :, None, :])
    return d_pred, d_gt


def bond_loss(x_denoised, x_gt, token_bonds, t_hat, *, sigma_data,
              token_id_to_centre_atom_id, eps: float = 1e-9):
    """Token-bond centre-atom length MSE with EDM weighting (loss.py:245-305)."""
    d_pred, d_gt = _centre_distances(x_denoised, x_gt, token_id_to_centre_atom_id)
    diff = d_pred - d_gt[None]
    per = torch.sum(token_bonds[None] * diff**2, dim=(-1, -2)) / (
        torch.sum(token_bonds, dim=(-1, -2)) + eps)
    return torch.mean(_edm_weight(t_hat, sigma_data) * torch.mean(per))


def key_res_loss(x_denoised, x_gt, t_hat, *, is_ligand, is_key_res, sigma_data,
                 token_id_to_centre_atom_id, eps: float = 1e-9):
    """Soft-lDDT^2 on key-residue <-> ligand centre-atom distances
    (loss.py:523-556)."""
    d_pred, d_gt = _centre_distances(x_denoised, x_gt, token_id_to_centre_atom_id)
    diff = smooth_lddt_epsilon(torch.abs(d_pred - d_gt[None]))
    mask = (is_key_res[:, None] * is_ligand[None])[None]
    loss = torch.mean(torch.sum(mask[None] * diff**2, dim=(-1, -2))
                      / (torch.sum(mask, dim=(-1, -2)) + eps))
    return torch.mean(loss * torch.mean(_edm_weight(t_hat, sigma_data)))


def distogram_loss(p_distogram, x_gt, x_exists, token_id_to_pseudo_beta_atom_id, *,
                   min_bin: float = 3.25, max_bin: float = 50.75, no_bins: int = 39):
    """Pseudo-beta distogram cross entropy over 39 squared-distance bins
    (loss.py:80-117)."""
    xb = x_gt.index_select(-2, token_id_to_pseudo_beta_atom_id)
    e = x_exists.index_select(-1, token_id_to_pseudo_beta_atom_id)
    mask = e[..., None] * e[..., None, :]
    boundaries = torch.linspace(min_bin, max_bin, no_bins - 1, dtype=torch.float32,
                                device=x_gt.device) ** 2
    d2 = torch.sum((xb[..., None, :] - xb[..., None, :, :]) ** 2, dim=-1, keepdim=True)
    true_bins = torch.sum(d2 > boundaries, dim=-1)
    errors = softmax_cross_entropy(
        p_distogram * mask[..., None],
        F.one_hot(true_bins, no_bins).to(p_distogram.dtype) * mask[..., None])
    return masked_mean(mask, errors, dim=(-1, -2))


def express_coordinates_in_frame(x, frames):
    """Express x [..., A, 3] in the local frames [..., F, 3, 3] built from
    3-atom triplets (loss_module3.py:214-237 / loss.py:189-215). Returns
    (coords [..., F, A, 3], valid [..., F]): a frame is valid when its
    angle at the middle atom is above 25 degrees."""
    a, b, c = frames[..., 0, :], frames[..., 1, :], frames[..., 2, :]

    def unit(v):
        return v / torch.linalg.norm(v + 1e-6, dim=-1, keepdim=True)

    w1, w2 = unit(a - b), unit(c - b)
    valid = torch.sum(w1 * w2, dim=-1) < 0.906308  # cos(25 deg)
    e1, e2 = unit(w1 + w2), unit(w2 - w1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    rot = torch.stack([e1, e2, e3], dim=-2)
    d = x[..., None, :, :] - b[..., None, :]
    return torch.einsum("...fij,...faj->...fai", rot, d), valid


def cal_lddt(x_pred, x_gt, is_dna, is_rna, is_polymer, token_id_to_centre_atom_id):
    """Per-atom lDDT against the polymer token centres (loss.py:323-380):
    x_pred [S, A, 3] -> [S, A]."""
    xc_pred = _centres(x_pred, token_id_to_centre_atom_id)
    xc_gt = _centres(x_gt, token_id_to_centre_atom_id)
    is_nuc = (is_dna + is_rna)[..., None, :]
    d_pred = _norm(x_pred[..., :, None, :] - xc_pred[..., None, :, :])
    d_gt = _norm(x_gt[..., :, None, :] - xc_gt[..., None, :, :])
    d_lm = torch.abs(d_pred - d_gt)
    score = 0.25 * sum((d_lm < cut).float() for cut in (0.5, 1.0, 2.0, 4.0))
    mask_r = (d_gt < 30) * is_nuc + (d_gt < 15) * (1 - is_nuc)
    mask_r = mask_r * is_polymer[..., None, :]
    return torch.sum(mask_r * score, dim=-1) / (torch.sum(mask_r, dim=-1) + 1e-9)


def _binned_ce(logits, error, mask, min_bin, max_bin, no_bins):
    """Cross entropy of `logits` against the bin of `error` (no gradient
    through the label), masked as the JAX package masks it."""
    bins = torch.clamp(((error - min_bin) / (max_bin - min_bin) * no_bins).to(torch.int64),
                       0, no_bins - 1)
    labels = F.one_hot(bins.detach(), no_bins).to(logits.dtype)
    return softmax_cross_entropy(logits * mask[..., None], labels * mask[..., None])


def plddt_loss(p_plddt, x_pred, x_gt, x_exists, *, no_bins, is_dna, is_rna, is_ligand,
               token_id_to_centre_atom_id):
    """Binned pLDDT cross entropy (loss.py:383-438) on sample 0."""
    lddt = cal_lddt(x_pred, x_gt, is_dna, is_rna, 1.0 - is_ligand,
                    token_id_to_centre_atom_id)[0].detach()
    l = _binned_ce(p_plddt, lddt, x_exists, 0.0, 1.0, no_bins)
    return masked_mean(x_exists, l, dim=-1)


def pde_loss(p_pde, x_pred, x_gt, x_exists, *, token_id_to_centre_atom_id,
             min_bin: float = 0.0, max_bin: float = 32.0, no_bins: int = 64):
    """Predicted-distance-error cross entropy (loss.py:487-520) on sample 0."""
    xc_pred = _centres(x_pred, token_id_to_centre_atom_id)
    xc_gt = _centres(x_gt, token_id_to_centre_atom_id)
    d_pred = _norm(xc_pred[..., :, None, :] - xc_pred[..., None, :, :])
    d_gt = _norm(xc_gt[..., :, None, :] - xc_gt[..., None, :, :])
    d_diff = torch.abs(d_pred - d_gt)[0]
    e = x_exists.index_select(-1, token_id_to_centre_atom_id)
    mask = e[..., None] * e[..., None, :]
    errors = _binned_ce(p_pde, d_diff, mask, min_bin, max_bin, no_bins)
    return masked_mean(mask, errors, dim=(-1, -2))


def pae_loss(p_pae, x_pred, x_gt, x_exists, *, token_id_to_centre_atom_id,
             token_id_to_frame_atom_id_0, token_id_to_frame_atom_id_1,
             token_id_to_frame_atom_id_2, min_bin: float = 0.0, max_bin: float = 32.0,
             no_bins: int = 64):
    """Predicted-aligned-error cross entropy (loss.py:423-470): the token
    centres of sample 0 expressed in every token's 3-atom frame, against
    the GT's; as in the reference, an invalid (near-collinear) frame zeroes
    the error instead of masking the term."""
    frame_ids = torch.stack([token_id_to_frame_atom_id_0, token_id_to_frame_atom_id_1,
                             token_id_to_frame_atom_id_2], dim=-1)  # [T, 3]
    tok_exists = x_exists.index_select(-1, token_id_to_centre_atom_id)
    gt_exp, gt_valid = express_coordinates_in_frame(
        _centres(x_gt, token_id_to_centre_atom_id), x_gt[frame_ids])
    x0 = x_pred[0]
    pred_exp, pred_valid = express_coordinates_in_frame(
        _centres(x0, token_id_to_centre_atom_id), x0[frame_ids])
    error = _norm(pred_exp - gt_exp) * gt_valid[..., None] * pred_valid[..., None]
    mask = tok_exists[..., None] * tok_exists[..., None, :]
    l = _binned_ce(p_pae, error, mask, min_bin, max_bin, no_bins)
    return masked_mean(mask, l, dim=(-1, -2))


def clamp_distance_loss(x_denoised, x_gt, x_exists, *, max_clamp_distance: float = 16.0):
    """Mean |pair-distance error| below the GT clamp (training-era variant;
    loss_module.py:160-184)."""
    d_pred = _norm(x_denoised[..., None, :] - x_denoised[..., None, :, :])
    d_gt = _norm(x_gt[..., None, :] - x_gt[..., None, :, :])
    mask = (d_gt < max_clamp_distance) * x_exists[..., None] * x_exists[..., None, :]
    err = torch.abs(d_pred - d_gt[..., None, :, :])
    return torch.mean(masked_mean(mask[..., None, :, :], err, dim=(-1, -2)))


def _nan_to_zero(x):
    """The reference's NaN/Inf loss zeroing (loss.py:616-620)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def physdock_loss(outputs: Batch, feats: Batch, cfg: LossConfig, sigma_data: float = 16.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Aggregate release loss (PhysDockLoss; loss.py:576-624). Returns the
    weighted sum and the unweighted terms plus `loss`."""
    x, t_hat = outputs["x_denoised"], outputs["t_hat"]
    x_gt, x_exists = feats["x_gt"], feats["x_exists"]
    centres = feats["token_id_to_centre_atom_id"]
    terms = {
        "weighted_mse_loss": (cfg.alpha_diffusion, weighted_mse_loss(
            x, x_gt, t_hat, sigma_data=sigma_data, is_dna=feats["is_dna"],
            is_rna=feats["is_rna"], is_ligand=feats["is_ligand"], alpha_dna=cfg.alpha_dna,
            alpha_rna=cfg.alpha_rna, alpha_ligand=cfg.alpha_ligand,
            atom_id_to_token_id=feats["atom_id_to_token_id"], x_exists=x_exists)),
        "smooth_lddt_loss": (cfg.alpha_diffusion, smooth_lddt_loss(
            x, x_gt, x_exists, max_clamp_distance=cfg.max_clamp_distance)),
        "bond_loss": (cfg.alpha_diffusion * cfg.alpha_bond, bond_loss(
            x, x_gt, feats["token_bonds"], t_hat, sigma_data=sigma_data,
            token_id_to_centre_atom_id=centres)),
        "key_res_loss": (cfg.alpha_diffusion * cfg.alpha_bond, key_res_loss(
            x, x_gt, t_hat, is_ligand=feats["is_ligand"], is_key_res=feats["is_key_res"],
            sigma_data=sigma_data, token_id_to_centre_atom_id=centres)),
        "distogram_loss": (cfg.alpha_distogram, distogram_loss(
            outputs["p_distogram"], x_gt, x_exists, feats["token_id_to_pseudo_beta_atom_id"],
            min_bin=cfg.distogram_min_bin, max_bin=cfg.distogram_max_bin,
            no_bins=cfg.distogram_no_bins)),
    }
    cum = 0.0
    logs = {}
    for name, (weight, value) in terms.items():
        value = _nan_to_zero(value)
        cum = cum + weight * value
        logs[name] = value
    logs["loss"] = cum
    return cum, logs


def rffold_loss(outputs: Batch, feats: Batch, cfg: LossConfig, sigma_data: float = 16.0,
                use_mini_rollout: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training-era aggregate (RFFoldLoss; loss_module3.py:573-628): the
    release set plus, under the mini-rollout and when the outputs carry
    the head's logits and `x_pred`, the pLDDT, PAE and PDE losses."""
    cum, logs = physdock_loss(outputs, feats, cfg, sigma_data)
    if not (use_mini_rollout and "p_plddt" in outputs):
        return cum, logs
    x_pred, x_gt, x_exists = outputs["x_pred"], feats["x_gt"], feats["x_exists"]
    centres = feats["token_id_to_centre_atom_id"]
    extra = {
        "plddt_loss": (cfg.alpha_confidence, plddt_loss(
            outputs["p_plddt"], x_pred, x_gt, x_exists, no_bins=cfg.plddt_no_bins,
            is_dna=feats["is_dna"], is_rna=feats["is_rna"], is_ligand=feats["is_ligand"],
            token_id_to_centre_atom_id=centres)),
        "pae_loss": (cfg.alpha_confidence * cfg.alpha_pae, pae_loss(
            outputs["p_pae"], x_pred, x_gt, x_exists, token_id_to_centre_atom_id=centres,
            token_id_to_frame_atom_id_0=feats["token_id_to_frame_atom_id_0"],
            token_id_to_frame_atom_id_1=feats["token_id_to_frame_atom_id_1"],
            token_id_to_frame_atom_id_2=feats["token_id_to_frame_atom_id_2"],
            min_bin=cfg.pae_min_bin, max_bin=cfg.pae_max_bin, no_bins=cfg.pae_no_bins)),
        "pde_loss": (cfg.alpha_confidence, pde_loss(
            outputs["p_pde"], x_pred, x_gt, x_exists, token_id_to_centre_atom_id=centres,
            min_bin=cfg.pde_min_bin, max_bin=cfg.pde_max_bin, no_bins=cfg.pde_no_bins)),
    }
    for name, (weight, value) in extra.items():
        value = _nan_to_zero(value)
        cum = cum + weight * value
        logs[name] = value
    logs["loss"] = cum
    return cum, logs
