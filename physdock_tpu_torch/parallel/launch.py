"""Run a function in several processes of one host, joined in a process
group: the harness of the distributed tests on the CPU (gloo) and of the
two-rank phases that share one card.

    results = run_ranks(fn, 2, args=(x,), rdv_dir=tmp)  # fn(rank, world, x)

Each rank sets its torch thread count, joins the group through a
`file://` rendezvous in `rdv_dir` (no port to collide with another run),
calls `fn`, and hands its return value back through a file there. A rank
that raises fails the whole call (`torch.multiprocessing` re-raises it in
the caller), and the group's timeout bounds a hang.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Callable, List, Sequence

import torch


def _rank_main(rank, fn, world_size, args, backend, url, timeout_s, out_dir, threads):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=url, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), rdv_dir: str = ".",
              backend: str = "gloo", timeout_s: float = 120.0, threads: int = 1) -> List[Any]:
    """fn(rank, world_size, *args) in `world_size` spawned processes; their
    return values in rank order. `fn` must be importable by name (a
    module-level function)."""
    import torch.multiprocessing as mp

    os.makedirs(rdv_dir, exist_ok=True)
    url = "file://" + os.path.abspath(os.path.join(rdv_dir, "rendezvous"))
    if os.path.exists(url[len("file://"):]):
        os.remove(url[len("file://"):])
    mp.start_processes(_rank_main, args=(fn, world_size, tuple(args), backend, url, timeout_s,
                                         rdv_dir, threads),
                       nprocs=world_size, join=True, start_method="spawn")
    return [torch.load(os.path.join(rdv_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
