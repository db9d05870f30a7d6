"""Device mesh and batch sharding over ``torch.distributed``.

Port of ``mamba_unet_tpu/parallel/mesh.py``. JAX's mesh is an array of
devices with named axes, and a sharding says how an array lies over it. The
port runs one process per rank: :func:`make_mesh` arranges the ranks of the
default process group row-major into named axes and makes one process group
per axis line, :func:`shard_batch` takes this rank's rows of a global batch
(the data that JAX's ``batch_sharding`` puts on this device), and
:func:`replicated` broadcasts a tensor or a module's parameters and
buffers from rank 0 of an axis. Without an initialized process group the
mesh has one rank, the counterpart of JAX's "all local devices" default on
one device. The same code runs under ``gloo`` (CPU ranks, or several ranks
sharing one card) and ``nccl`` (one card per rank).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mamba_unet_torch.parallel.comm import BatchShard


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape[axis]`` is an axis's size; :meth:`index` this rank's position
    on it; :meth:`group` the process group of this rank's line along it
    (None for an axis of one rank, on which every collective of
    ``parallel/comm.py`` is the identity)."""

    def __init__(self, axes: Sequence[str], shape: Sequence[int], rank: int,
                 groups: Dict[str, Optional[object]]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = rank
        self._coords = dict(zip(self.axis_names, np.unravel_index(
            rank, tuple(shape))))
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        return int(self._coords[axis])

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A :class:`Mesh` over every rank of the default process group.
    Default: all ranks on the first axis (pure data parallelism);
    ``axes``/``shape`` allow e.g. axes=("data", "model"), shape=(2, 2).
    Every rank must call it with the same arguments (it creates process
    groups)."""
    axes = tuple(axes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"axes {axes} and shape {shape} differ in length")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    ranks = np.arange(world).reshape(shape)
    groups: Dict[str, Optional[object]] = {}
    for a, axis in enumerate(axes):
        groups[axis] = None
        if shape[a] == 1:
            continue
        # every line along the axis, in the same order on every rank
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for idx in itertools.product(*others):
            sel = list(idx)
            sel.insert(a, slice(None))
            line = ranks[tuple(sel)].tolist()
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return Mesh(axes, shape, rank, groups)


def batch_sharding(mesh: Mesh, axis: str = "data") -> BatchShard:
    """Shard the leading (batch) dimension over ``axis``: this rank's
    :class:`parallel.comm.BatchShard`."""
    return BatchShard(mesh.group(axis), mesh.index(axis), mesh.shape[axis])


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of every tensor or array of a (nested) dict, list
    or tuple of them."""
    sh = batch_sharding(mesh, axis)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        return sh.rows(x)

    return take(batch)


def replicated(value, mesh: Mesh, axis: str = "data"):
    """Broadcast from rank 0 of ``axis`` to its other ranks. A tensor is
    broadcast in place and returned; a module's parameters and buffers
    are broadcast in place and the module returned."""
    group = mesh.group(axis)
    if group is None:
        return value
    src = dist.get_global_rank(group, 0)
    tensors = ([value] if isinstance(value, torch.Tensor) else
               list(value.parameters()) + list(value.buffers())
               if isinstance(value, nn.Module) else None)
    if tensors is None:
        raise TypeError(f"replicated takes a tensor or a module, got "
                        f"{type(value).__name__}")
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src, group=group)
    return value
