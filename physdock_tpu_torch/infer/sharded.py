"""Multi-card sampling: the diffusion-sample axis split over dp (port of
`physdock_tpu/infer/sharded.py`).

Poses are independent, so each dp rank runs its num_sample/dp of them
from the same conditioning (every rank computes the trunk, as the JAX
package replicates it) and the poses are all-gathered at the end.  Each
pose gets exactly the noise it gets unsharded: every rank makes every
draw of the whole pass from one generator, seeded alike, and keeps its
poses' slice (`model/diffusion.py`, `sample_range`).  Under an active tp
mesh the DiT's bias cache is row-sharded as well (`parallel/tp.py`), so
dp x tp compose: poses over dp, pair rows over tp.
"""

from __future__ import annotations

import torch

from physdock_tpu_torch.model.diffusion import sample_diffusion
from physdock_tpu_torch.parallel.mesh import Mesh, all_gather


@torch.no_grad()
def sharded_sample_diffusion(model, batch, mesh: Mesh, num_sample: int, **kw) -> torch.Tensor:
    """`sample_diffusion` with its `num_sample` poses split over the mesh's
    dp ranks. Returns all [num_sample, A, 3] poses (or the trajectory
    [steps, num_sample, A, 3]) on every rank."""
    if num_sample % mesh.dp:
        raise ValueError(f"num_sample {num_sample} does not split over dp={mesh.dp}")
    per = num_sample // mesh.dp
    lo = mesh.dp_rank * per
    x = sample_diffusion(model, batch, num_sample=num_sample, sample_range=(lo, lo + per), **kw)
    if mesh.dp_group is None:
        return x
    return all_gather(x, mesh.dp_group, dim=-3)
