"""Pose corruption for confidence-head training (port of
`physdock_tpu/train/corrupt.py`).

A memorized denoiser's mini-rollouts all land near the GT, so the pLDDT,
PAE and PDE labels they give are constant and the head collapses to a
constant distribution.  A corrupted pose spans the label bins: a random
error magnitude per draw drives a rigid ligand displacement and rotation,
per-atom ligand jitter and a smaller receptor jitter.

`corrupt_pose_draws` makes the five draws from an explicit
`torch.Generator` on the CPU; `corrupt_pose_from_draws` is the arithmetic,
so a test can feed it the JAX package's draws (its `jax.random.split(key,
5)`: magnitude, direction, rotation, ligand jitter, receptor jitter).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from physdock_tpu_torch.utils.geometry import uniform_random_rotation


def corrupt_pose_draws(generator: Optional[torch.Generator], n_atoms: int
                       ) -> Dict[str, torch.Tensor]:
    """The draws of one corrupted pose, on the CPU: u ~ U[0, 1), a normal
    direction [3], a uniform rotation [3, 3] and two normal jitters [A, 3]."""
    return {
        "u": torch.rand((), generator=generator),
        "direction": torch.randn(3, generator=generator),
        "rot": uniform_random_rotation((), generator, "cpu"),
        "jitter_lig": torch.randn((n_atoms, 3), generator=generator),
        "jitter_rec": torch.randn((n_atoms, 3), generator=generator),
    }


@torch.no_grad()
def corrupt_pose_from_draws(x_gt, x_exists, is_ligand_atom, draws: Dict[str, torch.Tensor],
                            min_mag: float = 0.1, max_mag: float = 24.0):
    """A corrupted pose [1, A, 3] (fp32, no gradient) from x_gt [A, 3]:
    the ligand error magnitude is log-uniform in [min_mag, max_mag] A and
    the receptor gets 5 % of it, at most 0.5 A."""
    dev = x_gt.device
    u, direction, rot, jit_l, jit_r = (draws[k].to(dev, torch.float32) for k in (
        "u", "direction", "rot", "jitter_lig", "jitter_rec"))
    m = min_mag * (max_mag / min_mag) ** u  # log-uniform magnitude

    w_lig = (is_ligand_atom * x_exists)[:, None]
    w_rec = ((1.0 - is_ligand_atom) * x_exists)[:, None]

    # rigid ligand move: rotation about the ligand centroid + translation
    lig_centre = torch.sum(x_gt * w_lig, dim=0) / (torch.sum(w_lig) + 1e-6)
    angle_scale = torch.clamp(m / 8.0, max=1.0)  # a full random rotation by ~8 A
    eye = torch.eye(3, dtype=rot.dtype, device=dev)
    rot = eye + angle_scale * (rot - eye)  # blend toward the identity when small
    # re-orthonormalize the blend (QR, signs fixed, keeps it a rotation)
    q, r = torch.linalg.qr(rot)
    rot = q * torch.sign(torch.diagonal(r))[None, :]
    direction = direction / (torch.linalg.norm(direction) + 1e-9)

    x_lig = (x_gt - lig_centre) @ rot.T + lig_centre + m * direction
    x_lig = x_lig + 0.2 * m * jit_l
    x_rec = x_gt + torch.clamp(0.05 * m, max=0.5) * jit_r
    x = x_lig * w_lig + x_rec * w_rec + x_gt * (1.0 - w_lig - w_rec)
    return x[None].float()


def corrupt_pose(generator: Optional[torch.Generator], x_gt, x_exists, is_ligand_atom,
                 min_mag: float = 0.1, max_mag: float = 24.0):
    """`corrupt_pose_from_draws` with fresh draws from `generator`."""
    draws = corrupt_pose_draws(generator, x_gt.shape[-2])
    return corrupt_pose_from_draws(x_gt, x_exists, is_ligand_atom, draws, min_mag, max_mag)
