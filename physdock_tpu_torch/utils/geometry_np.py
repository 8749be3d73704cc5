"""NumPy geometry twins for host featurization (the NumPy half of
`physdock_tpu/utils/geometry.py`); no torch, so the featurizer worker
(`data/feat_worker.py`) loads without it."""

from __future__ import annotations

import numpy as np


def uniform_random_rotation_np(rng: np.random.Generator, shape=()):
    """NumPy twin of utils/geometry.uniform_random_rotation for host featurization."""

    def sphere():
        phi = rng.random(shape) * 2 * np.pi
        theta = np.arccos(rng.random(shape) * 2 - 1)
        return np.stack(
            [np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta), np.cos(theta)],
            axis=-1,
        )

    e0 = sphere()
    u1 = sphere()
    e1 = u1 - e0 * np.sum(u1 * e0, axis=-1, keepdims=True)
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(e0, e1)
    return np.stack([e0, e1, e2], axis=-2)


def random_rigid_transform_np(rng: np.random.Generator, pos: np.ndarray):
    """Random rotation + unit-normal translation applied to [N, 3] points
    (per-conformer ref_pos augmentation in the featurizer)."""
    rot = uniform_random_rotation_np(rng)
    t = rng.normal(size=(3,))
    return pos @ rot.T + t
