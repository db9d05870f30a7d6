"""Differentiable collectives over a ``torch.distributed`` process group.

The JAX package writes its parallel paths under ``shard_map``, where a
replicated input, a sharded input and the assembled output each get their
transpose from JAX. Here each is an ``autograd.Function`` with its
backward written out, so that every rank ends a backward with the full
gradient of every replicated parameter, as the JAX step does:

* :func:`copy_in` - a replicated tensor entering a sharded computation:
  identity forward, gradients summed over the group in the backward;
* :func:`scatter_in` - this rank's slice of a replicated tensor; the
  backward gathers the slices' gradients back to the whole tensor;
* :func:`gather_out` - the slices assembled into the whole tensor on every
  rank; the backward keeps this rank's slice of the (replicated) gradient;
* :func:`all_gather_stack` - every rank's tensor, stacked; the backward sums
  each slot's gradient over the ranks and keeps this rank's;
* :func:`all_reduce` - the sum over the group, forward and backward (the
  sums of a data-parallel step: BatchNorm statistics, loss terms);
* :func:`ring_shift` - rank i - 1's tensor on rank i (a pipeline stage's
  hand-off); the backward sends each cotangent back;
* :func:`sum_replicated` - the one rank's value of a tensor the others
  hold as zeros, on every rank; the backward passes the cotangent on.

Every one is the identity on a one-rank group (``group`` None). They use
only ``all_reduce``, ``all_gather`` and ``broadcast``, which ``gloo`` runs
on CPU and CUDA tensors and ``nccl`` on CUDA tensors (``gloo`` has no
all-to-all and no point-to-point on CUDA tensors).

:class:`BatchShard` and :func:`batch_shard` tell the layers that draw
random masks or compute batch statistics that their batch is this rank's
rows of a global batch (data parallelism, ``train/trainer.py``): its part
of each block of the batch (a two-stream batch's labeled rows, then its
unlabeled ones), so that every rank holds rows of every block and runs
every pass. :func:`gather_rows` assembles the global batch from them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group) -> list:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim``: ``torch.tensor_split``'s,
    so parts differ by at most one (the first ones larger)."""
    n = group_size(group)
    if x.shape[dim] < n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {n} ranks")
    return torch.tensor_split(x, n, dim)[group_rank(group)]


def _gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts concatenated along ``dim`` (parts of sizes that may
    differ, as :func:`_slice` cuts them): each is padded to the largest
    for the all-gather and trimmed after."""
    sizes = [int(t) for t in _all_gather(
        torch.tensor([x.shape[dim]], dtype=torch.float32, device=x.device),
        group)]
    top = max(sizes)
    if x.shape[dim] < top:
        pad = list(x.shape)
        pad[dim] = top - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    parts = _all_gather(x, group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                     dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ScatterIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.dim, ctx.group), None, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _AllGatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.stack(_all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[group_rank(ctx.group)], None


class _RingShift(torch.autograd.Function):
    """Rank i receives rank i - 1's tensor (rank 0 rank S - 1's); the
    backward hands each cotangent back to its sender."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        parts = _all_gather(y, group)
        return parts[(group_rank(group) - 1) % group_size(group)].clone()

    @staticmethod
    def backward(ctx, g):
        parts = _all_gather(g, ctx.group)
        return parts[(group_rank(ctx.group) + 1) %
                     group_size(ctx.group)].clone(), None


class _SumReplicated(torch.autograd.Function):
    """The sum over the group of tensors of which one rank holds the value
    and the others zeros, for a computation that every rank then runs on
    the same result: the backward hands the (replicated) cotangent to
    every rank's term as it is."""

    @staticmethod
    def forward(ctx, y, group):
        return _all_reduce(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group; the backward sums the gradients."""
    return x if group is None else _AllReduce.apply(x, group)


def copy_in(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` (replicated); the backward sums its gradient over the group."""
    return x if group is None else _CopyIn.apply(x, group)


def scatter_in(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's contiguous part of ``x`` along ``dim`` (n parts whose
    sizes differ by at most one, as ``torch.tensor_split`` cuts them)."""
    return x if group is None else _ScatterIn.apply(x, dim, group)


def gather_out(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``, on every rank."""
    return x if group is None else _GatherOut.apply(x, dim, group)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order."""
    return x[None] if group is None else _AllGatherStack.apply(x, group)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i's result is rank i - 1's ``x`` (rank 0's rank n - 1's); the
    backward hands each cotangent back to its sender."""
    return x if group is None else _RingShift.apply(x, group)


def sum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group of ``x``, where one rank holds the value and
    the others zeros, for a computation that every rank then runs on the
    same result: the backward hands the cotangent on as it is."""
    return x if group is None else _SumReplicated.apply(x, group)


def check_blocks(blocks: Sequence[int], count: int) -> None:
    """Raise ``ValueError`` unless every block of ``blocks`` (row counts)
    splits into ``count`` equal parts."""
    for b in blocks:
        if b % count:
            raise ValueError(f"a block of {b} rows does not split over "
                             f"{count} data ranks")


class BatchShard(NamedTuple):
    """This rank's rows of a global batch: the ``index``-th of ``count``
    equal parts of each of its ``blocks`` (the blocks' global row counts,
    e.g. a two-stream batch's labeled and unlabeled rows; empty: the whole
    batch is one block), the sums over the batch taken over ``group``.
    Each rank's rows keep the blocks' order, so a block's local rows are
    its global count over ``count``."""
    group: Optional[object]
    index: int
    count: int
    blocks: Tuple[int, ...] = ()

    def with_blocks(self, *blocks: int) -> "BatchShard":
        """The same shard of a batch made of ``blocks``."""
        return self._replace(blocks=tuple(int(b) for b in blocks))

    def scaled(self, k: int) -> "BatchShard":
        """The shard of a batch whose every row became ``k`` consecutive
        rows (a sample's cubes)."""
        return self._replace(blocks=tuple(k * b for b in self.blocks))

    def _parts(self, n: int):
        """(start, length) of this rank's part of each block of a global
        batch of ``n`` rows."""
        blocks = self.blocks or (n,)
        if sum(blocks) != n:
            raise ValueError(f"a batch of {n} rows is not made of the "
                             f"blocks {blocks}")
        check_blocks(blocks, self.count)
        start = 0
        for b in blocks:
            part = b // self.count
            yield start + self.index * part, part
            start += b

    def rows(self, x):
        """This rank's rows of ``x`` (a tensor or an array), whose first
        axis is the global batch."""
        parts = [x[s:s + n] for s, n in self._parts(x.shape[0])]
        if len(parts) == 1:
            return parts[0]
        if isinstance(x, torch.Tensor):
            return torch.cat(parts)
        return np.concatenate(parts)


def gather_rows(x: torch.Tensor, shard: Optional[BatchShard]
                ) -> torch.Tensor:
    """The global batch, on every rank, from each rank's rows ``x``
    (:meth:`BatchShard.rows`' inverse). The backward sums each row's
    gradient over the ranks and keeps this rank's rows: unlike
    :func:`gather_out`, whose backward takes a gradient that every rank
    holds whole, each rank's graph may reach any row (a cube shuffle
    across the batch)."""
    if shard is None or shard.count == 1:
        return x
    # (count, local rows, ...), gathered in at least fp32 (gloo's types)
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    stacked = all_gather_stack(wide, shard.group).to(x.dtype)
    n = x.shape[0]
    out, start = [], 0
    for b in shard.blocks or (n * shard.count,):
        part = b // shard.count
        out.append(stacked[:, start:start + part].reshape(b, *x.shape[1:]))
        start += part
    return torch.cat(out)


_BATCH_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Within the block the layers see ``shard`` (None: the whole batch)."""
    token = _BATCH_SHARD.set(shard)
    try:
        yield shard
    finally:
        _BATCH_SHARD.reset(token)


def current_batch_shard() -> Optional[BatchShard]:
    """The active :class:`BatchShard`, or None for a whole batch."""
    shard = _BATCH_SHARD.get()
    return None if shard is None or shard.count == 1 else shard
