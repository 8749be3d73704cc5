"""Process groups of a dp x tp mesh over `torch.distributed` (port of
`physdock_tpu/parallel/mesh.py`).

The reference trains with DDP over NCCL (tasks/unicore_train/train.sh:69-81),
one process per card; so does the port: each process drives one card
(`cuda:{rank % device_count}`), where the JAX package runs one process per
host over all its chips.  The world splits into `dp` replicas of `tp` ranks
each, tp innermost: rank = dp_rank * tp + tp_rank, so a replica's pair-row
collectives stay on neighbouring cards.  `dp` shards the systems of a
train step (`train/step.py`) or the poses of a sampler pass
(`infer/sharded.py`); `tp` shards the pair tensors' query rows
(`parallel/tp.py`).

Without a process group (one process, as every single-card entry point
runs) `make_mesh` returns groups of None, and the dp and tp code issues no
collective at all, as `tp=1` traces the single-device program in JAX; nor
over an axis of one rank in a larger world.  An initialized group of
world size 1 keeps its (trivial) collectives, so a run can exercise a
backend on one card.

Collectives go through `all_reduce_` and `all_gather`, which NCCL and
gloo both run, gloo on CPU and CUDA tensors alike (the CPU tests run
gloo; so do two ranks sharing one card, which NCCL refuses).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    dp_rank: int = 0
    tp_rank: int = 0
    # this rank's replica axis and pair-row axis; None: no collective
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: Optional[str] = None, timeout_s: float = 1800.0) -> None:
    """Join the process group: `coordinator` is host:port (a TCP store on
    process 0) or an init URL such as file:///path. Backend: NCCL when
    CUDA is available, else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def close_distributed() -> None:
    """Leave the process group (after every rank's last collective)."""
    dist.barrier()
    dist.destroy_process_group()


def make_mesh(dp: int = -1, tp: int = 1) -> Mesh:
    """This rank's coordinates and groups; dp = world // tp by default.
    Every rank must call it, in the same order as any other group it
    makes."""
    n = world()
    if dp == -1:
        dp = n // tp
    if tp < 1 or dp < 1 or dp * tp != n:
        raise ValueError(f"mesh dp={dp} x tp={tp} does not cover the world of {n} processes")
    if not distributed():
        return Mesh(dp, tp)
    dp_rank, tp_rank = divmod(rank(), tp)

    def group(members: List[int]):
        # a group of one runs no collective, unless it is the whole world
        # (which then exercises the backend)
        made = dist.group.WORLD if len(members) == n else dist.new_group(members)
        return made if len(members) > 1 or n == 1 else None

    # every rank makes every group, in one order
    tp_groups = [group([d * tp + t for t in range(tp)]) for d in range(dp)]
    dp_groups = [group([d * tp + t for d in range(dp)]) for t in range(tp)]
    return Mesh(dp, tp, dp_rank, tp_rank, dp_groups[tp_rank], tp_groups[dp_rank])


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over `group`; returns x."""
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x`, concatenated along `dim` in group-rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
