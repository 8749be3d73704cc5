"""The JAX gate's training draws, reproduced in NumPy without JAX.

`scripts/overfit_gate.py` draws each step's noise from `jax.random` keys:
`PRNGKey(seed)`, then `fold_in(start_step)`, then one `split` per step;
each system of the step folds in its index (`fold_in(k_step, i)`, the
train step's per-system key at dp 1), and `augmentation_diffuse` splits
that key in three for the noise level, the noise and the centre
augmentation (whose key splits again for the rotation and translation).
This module computes the same numbers: JAX's threefry2x32 with its bit
layout under `jax_threefry_partitionable=True` (the default since JAX
0.5), JAX's float32 `uniform` (23 random mantissa bits), and its `normal`
(`sqrt(2) * erf_inv(u)` with u uniform on (-1, 1)), with XLA's float32
`erf_inv` polynomial.

Keys and uniform bits equal `jax.random`'s bit for bit; normals agree to
float32 rounding (the `log1p` inside `erf_inv` is NumPy's, not XLA's).
`tests/test_torch_jax_draws.py` holds both to `jax.random` on the CPU.

With a mini-rollout the JAX step splits each system's key into the
forward's and the rollout's (`k_fwd, k_roll`); `system_draws` does the
same and adds the rollout's noise (`rollout_draws`: the sampler's stream
per sample, split once per step) or the corrupted pose's draws
(`corrupt_draws`) in the port's layouts.

A diagnostic for the train-to-dock gate, not part of the package:
`scripts/torch_overfit_gate.py --draws jax` feeds these draws to the
port's train step through its `draws` argument.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's `threefry2x32_p`): the key's two
    words encrypt the counter words (x0, x1) elementwise."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` (raw uint32[2]) for a seed in [0, 2**32)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`."""
    o0, o1 = threefry2x32(key, np.array([0], np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([o0[0], o1[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` under the partitionable layout: key i is
    the encryption of counter (0, i), the same as `fold_in(key, i)`."""
    hi, lo = _counters(num)
    o0, o1 = threefry2x32(key, hi, lo)
    return np.stack([o0, o1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`: the xor of the two words
    encrypting each element's row-major index."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    o0, o1 = threefry2x32(key, hi, lo)
    return (o0 ^ o1).reshape(shape)


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 where w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0]).astype(np.float32)
        for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = (np.where(small, cs, cl) + p * w).astype(np.float32)
        out = p * x
    return np.where(np.abs(x) == 1, x * np.float32(np.finfo(np.float32).max), out).astype(np.float32)


def normal(key, shape=()) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erf_inv(u)).astype(np.float32)


def uniform_random_rotation(key, shape=()) -> np.ndarray:
    """`physdock_tpu.utils.geometry.uniform_random_rotation`: Gram-Schmidt on
    two uniform sphere points; [..., 3, 3] with rows (e0, e1, e2)."""
    k0, k1 = split(key)

    def sphere(k):
        kp, kt = split(k)
        phi = uniform(kp, shape) * np.float32(2 * np.pi)
        theta = np.arccos(uniform(kt, shape) * np.float32(2) - np.float32(1))
        return np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta),
                         np.cos(theta)], axis=-1).astype(np.float32)

    e0 = sphere(k0)
    u1 = sphere(k1)
    e1 = u1 - e0 * np.sum(u1 * e0, axis=-1, keepdims=True)
    e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
    return np.stack([e0, e1, np.cross(e0, e1)], axis=-2).astype(np.float32)


def augmentation_draws(key, n: int, n_atoms: int, sigma_data: float) -> dict:
    """The raw draws of `PhysDock.augmentation_diffuse(batch, key)` for
    `n` augmentation samples of `n_atoms` atoms: the noise level t_hat
    [n], the noise [n, A, 3], and the centre augmentation's rotation
    [n, 3, 3] and translation [n, 3]."""
    k_t, k_n, k_aug = split(key, 3)
    t_hat = np.exp(normal(k_t, (n,)) * np.float32(1.5) - np.float32(1.2)) * np.float32(sigma_data)
    kr, kt = split(k_aug)
    return {"t_hat": t_hat.astype(np.float32), "noise": normal(k_n, (n, n_atoms, 3)),
            "rot": uniform_random_rotation(kr, (n,)), "trans": normal(kt, (n, 3))}


def rollout_draws(key, n_atoms: int, steps: int) -> dict:
    """The draws of the JAX mini-rollout (`sample_diffusion` with one
    sample, no guidance) from its key `k_roll`, in the port's
    `noise_override` layout: the sample's stream `fold_in(key, 0)`, its
    init noise from `fold_in(stream, 0)`, then per step `stream, k_aug,
    k_churn = split(stream, 3)`, the centre augmentation's rotation and
    translation from `split(k_aug)` and the churn noise from `k_churn`.
    x_init_z [1, A, 3], aug_R [T, 1, 3, 3], aug_t [T, 1, 3], churn_z [T,
    1, A, 3]."""
    stream = fold_in(key, 0)
    x_init = normal(fold_in(stream, 0), (n_atoms, 3))
    rots, trans, churns = [], [], []
    for _ in range(steps):
        stream, k_aug, k_churn = split(stream, 3)
        kr, kt = split(k_aug)
        rots.append(uniform_random_rotation(kr, ()))
        trans.append(normal(kt, (3,)))
        churns.append(normal(k_churn, (n_atoms, 3)))
    return {"x_init_z": x_init[None], "aug_R": np.stack(rots)[:, None],
            "aug_t": np.stack(trans)[:, None], "churn_z": np.stack(churns)[:, None]}


def corrupt_draws(key, n_atoms: int) -> dict:
    """The five draws of the JAX `corrupt_pose` from its key `k_roll`
    (`split(key, 5)`), in `corrupt_pose_from_draws`' keys."""
    k_m, k_dir, k_rot, k_jl, k_jr = split(key, 5)
    return {"u": uniform(k_m, ()), "direction": normal(k_dir, (3,)),
            "rot": uniform_random_rotation(k_rot, ()),
            "jitter_lig": normal(k_jl, (n_atoms, 3)), "jitter_rec": normal(k_jr, (n_atoms, 3))}


def system_draws(key, x_gt, x_exists, n: int, sigma_data: float, mini_rollout_steps: int = 0,
                 corrupt: bool = False) -> dict:
    """One system's train-step draws from its JAX key, as `draw_system`
    gives them: {x_hat, t_hat} on x_gt's device, what `augmentation_diffuse`
    returns in the JAX package, computed with the port's centre
    augmentation. With a mini-rollout (`mini_rollout_steps` > 0) the key
    is split first, as the JAX step splits it (`k_fwd, k_roll`): x_hat
    and t_hat come from `k_fwd`, and the rollout's noise (or with
    `corrupt` the corrupted pose's draws), on the CPU, from `k_roll`."""
    import torch

    from physdock_tpu_torch.utils.geometry import apply_centre_augmentation

    n_atoms = x_gt.shape[-2]
    k_fwd, k_roll = split(key) if mini_rollout_steps else (key, None)
    d = augmentation_draws(k_fwd, n, n_atoms, sigma_data)
    dev, dt = x_gt.device, x_gt.dtype
    t_hat = torch.from_numpy(d["t_hat"]).to(dev)
    x = x_gt[None] + torch.from_numpy(d["noise"]).to(dev, dt) * t_hat[:, None, None]
    x_hat = apply_centre_augmentation(x, x_exists, torch.from_numpy(d["rot"]).to(dev),
                                      torch.from_numpy(d["trans"]).to(dev, dt))
    out = {"x_hat": x_hat.detach(), "t_hat": t_hat}
    if mini_rollout_steps and corrupt:
        out["corrupt"] = {k: torch.from_numpy(np.asarray(v))
                          for k, v in corrupt_draws(k_roll, n_atoms).items()}
    elif mini_rollout_steps:
        out["rollout"] = {k: torch.from_numpy(v)
                          for k, v in rollout_draws(k_roll, n_atoms, mini_rollout_steps).items()}
    return out


class GateKeys:
    """The JAX gate's key stream: `PRNGKey(seed)` folded with the window's
    start step, then one split per step (`scripts/overfit_gate.py`)."""

    def __init__(self, seed: int, start_step: int):
        self.key = fold_in(prng_key(seed), start_step)

    def next_step(self) -> np.ndarray:
        self.key, k_step = split(self.key)
        return k_step

    @staticmethod
    def system_key(k_step, i: int) -> np.ndarray:
        """System i's key in the step (dp 1: `fold_in(k_step, 0 * n + i)`)."""
        return fold_in(k_step, i)
