"""Seeded random weights, made on the device in one draw.

Every weight comes from one `torch.randn` of all the model's parameters,
drawn by a generator on the device seeded with the run's seed, then
scaled in place per tensor: a matrix [out, in] by 1/sqrt(in), a bias by
0.1, a norm's scale as 1 + 0.1 N(0, 1). No tensor is left at zero, so
every gate and residual branch of the model carries signal (the released
model's trained weights are not zeros either).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(spec: List[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the (name, shape) list `spec`, from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        w = flat[off: off + n].view(shape)
        off += n
        if len(shape) == 2:
            w.mul_(1.0 / math.sqrt(shape[1]))
        elif name.endswith(".bias"):
            w.mul_(0.1)
        else:
            w.mul_(0.1).add_(1.0)
        out[name] = w
    return out
