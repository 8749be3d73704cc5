"""Pose ranking by geometric clustering.

Port of `physdock_tpu/infer/ranking.py`, a re-implementation of the reference's release-path ranking
(redocking.py:357-437): pocket-frame-aligned ligand poses -> pairwise RMSD
matrix -> KMeans on the matrix rows -> per-cluster medoids, rank 0 = global
medoid.  Falls back to a dependency-free KMeans when sklearn is absent.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def pairwise_rmsd_matrix(poses: np.ndarray) -> np.ndarray:
    """poses: [S, L, 3] (already in a common frame) -> [S, S] RMSD."""
    diff = poses[:, None] - poses[None]  # [S, S, L, 3]
    return np.sqrt(np.mean(np.sum(diff**2, axis=-1), axis=-1))


def _kmeans(x: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = min(k, len(x))
    centres = x[rng.choice(len(x), k, replace=False)]
    labels = np.zeros(len(x), np.int64)
    for _ in range(iters):
        d = np.linalg.norm(x[:, None] - centres[None], axis=-1)
        new_labels = np.argmin(d, axis=-1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            m = labels == c
            if m.any():
                centres[c] = x[m].mean(0)
    return labels


def rank_poses(
    ligand_poses: np.ndarray,
    n_clusters: int = 5,
    scores: Optional[np.ndarray] = None,
) -> List[int]:
    """Return pose indices in rank order.

    rank 0 = global medoid (pose with minimal mean RMSD to all others);
    subsequent ranks = medoids of KMeans clusters of the RMSD-matrix rows,
    ordered by cluster size (largest first), deduped.
    `scores` (lower better, e.g. conformer-match epsilon) breaks ties.
    """
    n = len(ligand_poses)
    if n == 1:
        return [0]
    rmsd = pairwise_rmsd_matrix(ligand_poses)
    mean_rmsd = rmsd.mean(axis=-1)
    global_medoid = int(np.argmin(mean_rmsd))

    try:
        from sklearn.cluster import KMeans

        labels = KMeans(
            n_clusters=min(n_clusters, n), n_init=4, random_state=0
        ).fit_predict(rmsd)
    except ImportError:
        labels = _kmeans(rmsd, n_clusters)

    order = [global_medoid]
    cluster_ids, counts = np.unique(labels, return_counts=True)
    for c in cluster_ids[np.argsort(-counts)]:
        members = np.nonzero(labels == c)[0]
        within = rmsd[np.ix_(members, members)].mean(axis=-1)
        if scores is not None:
            within = within + 1e-3 * scores[members]
        medoid = int(members[np.argmin(within)])
        if medoid not in order:
            order.append(medoid)
    for i in np.argsort(mean_rmsd):
        if int(i) not in order:
            order.append(int(i))
    return order


def pocket_frame_align(
    x_pred: np.ndarray,  # [S, A, 3]
    x_gt: np.ndarray,  # [A, 3]
    pocket_ca_mask: np.ndarray,  # [A]
) -> np.ndarray:
    """Rigidly align each predicted complex onto the GT pocket-CA frame
    (redocking.py:341-356 align_mode=pocket_ca): the weighted Kabsch fit of
    `utils/geometry.weighted_rigid_align` in fp32 NumPy, so that the
    featurizer worker post-processes without torch."""
    x = np.asarray(x_pred, np.float32)
    gt = np.asarray(x_gt, np.float32)
    w = np.asarray(pocket_ca_mask, np.float32)[:, None]
    denom = w.sum()
    with np.errstate(divide="ignore", invalid="ignore"):  # no weight: raised below
        mu_gt = (gt * w).sum(0) / denom
        mu_x = (x * w).sum(1, keepdims=True) / denom
    x_hat = x - mu_x
    h = np.einsum("sij,ik->sjk", x_hat * w, gt - mu_gt)
    if not np.isfinite(h).all():  # e.g. a crop with no pocket or protein CA
        raise RuntimeError("pocket_frame_align: non-finite pocket frame (no pocket CA in the crop?)")
    u, _, vh = np.linalg.svd(h)
    u[np.linalg.det(u @ vh) < 0, :, 2] *= -1  # the reflection fix
    return (x_hat @ (u @ vh) + mu_gt).astype(np.float32)


def postprocess_poses(
    poses: np.ndarray,
    x_gt: np.ndarray,
    *,
    lig_idx: np.ndarray,
    centre_ids: np.ndarray,
    pocket_res: np.ndarray,
    is_protein: np.ndarray,
    s_mask: np.ndarray,
    a_mask: np.ndarray,
    enable_ranking: bool,
    compute_rmsd: bool,
    relax_fn=None,
    rank_scores=None,
):
    """Pocket-frame align, (optionally relax,) rank and score poses
    (redocking.py:341-447 host stages).  Pure NumPy: runs inline or inside
    the featurizer worker subprocess — pipeline.dock_many offloads it there
    so it overlaps the next system's device rounds instead of idling the
    device.  Returns (aligned [S, A, 3], rank order, lig_rmsds | None).

    `rank_scores` (per-pose, higher = better — e.g. the confidence head's
    ranking_confidence) overrides the geometric KMeans-medoid ranking."""
    pocket_tok = pocket_res * is_protein
    pocket_ca = np.zeros(len(a_mask), np.float32)
    sel = centre_ids[(pocket_tok > 0) & (s_mask > 0)]
    pocket_ca[sel] = 1.0
    if pocket_ca.sum() < 3:  # fallback: all CAs
        pocket_ca[centre_ids[is_protein > 0]] = 1.0
    pocket_ca = pocket_ca * a_mask
    aligned = pocket_frame_align(poses, x_gt, pocket_ca)
    if relax_fn is not None:
        aligned = relax_fn(aligned)
    order = list(range(len(aligned)))
    if rank_scores is not None:
        order = [int(i) for i in np.argsort(-np.asarray(rank_scores))]
    elif enable_ranking and len(lig_idx):
        order = rank_poses(aligned[:, lig_idx], n_clusters=5)
    lig_rmsds = None
    if compute_rmsd and len(lig_idx):
        gt_lig = x_gt[lig_idx]
        lig_rmsds = [
            float(np.sqrt(np.mean(np.sum((aligned[i][lig_idx] - gt_lig) ** 2, -1))))
            for i in order
        ]
    return aligned, order, lig_rmsds
