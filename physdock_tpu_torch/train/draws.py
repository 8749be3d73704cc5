"""Keyed training draws: one random stream per (step, system, purpose).

The JAX train step gives each system of each step its own key,
`fold_in(k_step, dp_rank * n_local + i)`, and splits it into the
forward's key and the mini-rollout's (`k_fwd, k_roll = split(key)`).
Here the key is the tuple (run seed, step, global system index, purpose),
mixed by NumPy's `SeedSequence` into the 64-bit seed of a fresh CPU
`torch.Generator`. A system's draws therefore depend on nothing else:
not on the other systems of the batch, the number of systems a rank
holds, the dp layout, or where a run was stopped and resumed. The draws
stay on the CPU and then move to the device, so a card run and a CPU run
from one seed see the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

# the streams of one system in one step: the forward's x_hat and t_hat,
# the mini-rollout's noise, the corrupted pose's draws
PURPOSES = {"forward": 0, "rollout": 1, "corrupt": 2}


def stream_seed(seed: int, step: int, index: int, purpose: str) -> int:
    """The 64-bit seed of the stream of system `index` (global) in step
    `step` of the run seeded `seed`, for `purpose` (`PURPOSES`)."""
    state = np.random.SeedSequence([seed, step, index, PURPOSES[purpose]]).generate_state(
        1, np.uint64)
    return int(state[0])


def stream(seed: int, step: int, index: int, purpose: str) -> torch.Generator:
    """A fresh CPU generator on that stream."""
    return torch.Generator().manual_seed(stream_seed(seed, step, index, purpose))
