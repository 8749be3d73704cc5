"""Tensor parallelism for the pair stacks: row-sharded [S, S, C] tensors
(port of `physdock_tpu/parallel/tp.py`).

Under a mesh with tp > 1 (`use_tp`, `enable_tp`) each of a replica's tp
ranks holds the query rows [r * S/tp, (r+1) * S/tp) of the pair tensor z
inside the Triangleformer, Evoformer and Pairformer stacks, and of the
DiT's cached attention biases. Where GSPMD placed the collectives for the
JAX package, the port places them explicitly (`nn/attentions.py`,
`nn/primitives.py::OuterProductMean`, `nn/transformers.py`):

  * row-local ops need none: the pair transition, the row queries of an
    attention, the outer product of a replicated MSA for the rank's rows;
  * the outgoing triangle update gathers its b projection, the incoming
    one both projections; starting-node triangle attention gathers its
    [H, S, S] bias; ending-node attention gathers the normalized z and
    works on its transpose;
  * an attention whose queries are replicated but whose bias arrives with
    the rank's rows (MSA rows, single attention, the DiT) runs those rows
    through the kernels against all keys (`ops/attention.py::
    _tp_sharded_flash`) and gathers the output rows.

Gradients: every rank back-propagates the same replicated loss, so
`gather_rows`' backward all-reduces the incoming gradient before it keeps
its rows; a rank's gradient of a replicated tensor (a parameter included)
is then its share of tp times the true one, and `reduce_grads` sums the
shares over tp and divides by tp.

Without an active tp mesh every function here is the identity, so the
single-card path runs no extra op.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch

from physdock_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_

# process-wide, not per thread: autograd recomputes a checkpointed block
# (`nn/transformers.py::run_block`) on its own device threads, which must
# shard as the forward did
_MESH: List[Optional[Mesh]] = [None]


def current_tp_mesh() -> Optional[Mesh]:
    return _MESH[0]


def tp_active() -> bool:
    return current_tp_mesh() is not None


def _usable(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


@contextmanager
def use_tp(mesh: Optional[Mesh]):
    """Shard the pair stacks' rows over `mesh`'s tp group inside the
    block; a mesh with tp = 1 (or None) leaves everything replicated."""
    prev = _MESH[0]
    _MESH[0] = mesh if _usable(mesh) else None
    try:
        yield
    finally:
        _MESH[0] = prev


def enable_tp(mesh: Optional[Mesh]) -> bool:
    """Process-lifetime `use_tp`, for entry points. Returns whether tp is
    active."""
    _MESH[0] = mesh if _usable(mesh) else None
    return _MESH[0] is not None


def row_range(n_rows: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of an axis of n_rows; raises unless
    n_rows divides by tp."""
    mesh = mesh or current_tp_mesh()
    if mesh is None:
        return 0, n_rows
    if n_rows % mesh.tp:
        raise ValueError(f"{n_rows} rows do not split over tp={mesh.tp}: S % tp must be 0")
    per = n_rows // mesh.tp
    return mesh.tp_rank * per, (mesh.tp_rank + 1) * per


def shard_rows(x: torch.Tensor, row_axis: int = -3) -> torch.Tensor:
    """This rank's S/tp rows of x along `row_axis` (z: [..., S_q, S_k, C]
    by default; a bias [..., H, S_q, S_k] or a mask [..., S_q, S_k] with
    -2). The identity without an active tp mesh."""
    mesh = current_tp_mesh()
    if mesh is None:
        return x
    lo, hi = row_range(x.shape[row_axis], mesh)
    return x.narrow(row_axis, lo, hi - lo)


def rows_like(x: torch.Tensor, n_rows: int, row_axis: int = -2) -> torch.Tensor:
    """x as it pairs with a tensor of `n_rows` rows: this rank's rows when
    x is whole and its partner row-sharded (a mask beside a sharded z),
    else x itself (a mask beside the atom pair grid, which stays whole)."""
    if current_tp_mesh() is None or x.shape[row_axis] == n_rows:
        return x
    return shard_rows(x, row_axis)


class _GatherRows(torch.autograd.Function):
    """Forward: all-gather the ranks' rows along `dim`. Backward: all-reduce
    the gradient of the whole (each rank holds its share) and keep this
    rank's rows. Only all_gather and all_reduce, which NCCL and gloo both
    have."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.rows = dim, mesh, x.shape[dim]
        return all_gather(x, mesh.tp_group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.mesh.tp_group)
        return g.narrow(ctx.dim, ctx.mesh.tp_rank * ctx.rows, ctx.rows), None, None


def gather_rows(x: torch.Tensor, row_axis: int = -3, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The whole of a row-sharded tensor on every rank (the identity
    without a tp mesh)."""
    mesh = mesh or current_tp_mesh()
    if mesh is None:
        return x
    return _GatherRows.apply(x, row_axis % x.dim(), mesh)


def replicate(x: torch.Tensor, row_axis: int = -3) -> torch.Tensor:
    """A row-sharded tensor made whole (replicated) at a sharded region's
    end; the identity without an active tp mesh."""
    return gather_rows(x, row_axis)


def reduce_grads(grads: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """In place: the true gradient from each tp rank's share (sum over tp,
    divided by tp), in one flat fp32 all-reduce. Nothing without tp."""
    if mesh is None or mesh.tp == 1 or mesh.tp_group is None:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_(flat, mesh.tp_group).div_(mesh.tp)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))
