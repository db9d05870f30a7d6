"""Tensor-parallel (channel-sharded) selective scan: d_inner split over a
mesh axis.

Port of ``mamba_unet_tpu/parallel/tp_scan.py``. The S6 recurrence is
independent across channels, so each rank scans its own dg block of every
one of the G direction groups, with the per-group B/C (N-sized, small)
replicated and the channel-indexed parameters (A rows, D, Δbias) sharded
beside the activations. The forward has no collective; the backward sums
B/C's gradients over the axis, as JAX's ``shard_map`` transposes a
replicated input. The scan is the public one (``ops/selective_scan.py``):
the grouped kernels on CUDA tensors, the plain loop on CPU tensors.

Channel layout: the scan's D axis is G groups x dg channels, and a flat
split of D would cut across groups, so a shard is a contiguous block of
dg / n channels in each group (:func:`shard_channels`,
:func:`gather_channels` cut and assemble it). With ``batch_axis`` the
batch is also split over a second axis, as JAX's (data, model) mesh does.
"""

from __future__ import annotations

import contextvars
from typing import Optional

import torch

from mamba_unet_torch.ops.selective_scan import selective_scan
from mamba_unet_torch.parallel.comm import copy_in, gather_out, scatter_in
from mamba_unet_torch.parallel.mesh import Mesh

_TP_CTX: contextvars.ContextVar = contextvars.ContextVar("channel_sharding",
                                                         default=None)


class channel_sharding:
    """Context manager enabling tensor-parallel scans inside models::

        with channel_sharding(mesh, "model", batch_axis="data"):
            y = model(x)        # SS2D(scan_impl="tp_sharded")
    """

    def __init__(self, mesh: Mesh, axis: str = "model",
                 batch_axis: Optional[str] = None):
        self.ctx = (mesh, axis, batch_axis)

    def __enter__(self):
        self._token = _TP_CTX.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _TP_CTX.reset(self._token)
        return False


def current_channel_sharding():
    """(mesh, axis, batch_axis) of the active :class:`channel_sharding`,
    or None."""
    return _TP_CTX.get()


def _group_view(x: torch.Tensor, G: int, dim: int) -> torch.Tensor:
    """``x`` with its axis ``dim`` of G * dg split into (G, dg)."""
    return x.reshape(*x.shape[:dim], G, -1, *x.shape[dim + 1:])


def shard_channels(x: torch.Tensor, G: int, dim: int, mesh: Mesh,
                   axis: str = "model") -> torch.Tensor:
    """This rank's block of ``x``'s G * dg channels on axis ``dim``: the
    same dg / n channels of each group (differentiable: the backward
    gathers the blocks' gradients)."""
    v = scatter_in(_group_view(x, G, dim), dim + 1, mesh.group(axis))
    return v.reshape(*x.shape[:dim], -1, *x.shape[dim + 1:])


def gather_channels(x: torch.Tensor, G: int, dim: int, mesh: Mesh,
                    axis: str = "model") -> torch.Tensor:
    """Inverse of :func:`shard_channels`: every rank's blocks assembled
    into the G * dg channels (the backward keeps this rank's block)."""
    v = gather_out(_group_view(x, G, dim), dim + 1, mesh.group(axis))
    return v.reshape(*x.shape[:dim], -1, *x.shape[dim + 1:])


def selective_scan_tp_sharded(
    u, delta, A, B, C,
    D=None, z=None, delta_bias=None, delta_softplus: bool = False,
    *, mesh: Mesh, axis: str = "model", batch_axis: Optional[str] = None,
):
    """Selective scan of this rank's channel block: u/delta/z
    (B, G * dg/n, L), A (G * dg/n, N), D/delta_bias (G * dg/n,), each the
    :func:`shard_channels` block of the full operand, and B/C
    (B, G, N, L) or (B, N, L), replicated over ``mesh[axis]``. With
    ``batch_axis`` the batch rows (of u, delta, z, B and C) are this
    rank's rows on that axis too, and the channel parameters A, D and
    delta_bias, replicated over it, get their gradients summed over it.
    Returns this rank's block of y (B, G * dg/n, L)."""
    bsz = u.shape[0]
    if batch_axis is not None and B.shape[0] != bsz:
        raise ValueError(f"B has {B.shape[0]} rows, u {bsz}")
    group = mesh.group(axis)
    bgroup = None if batch_axis is None else mesh.group(batch_axis)
    A, D, delta_bias = (None if t is None else copy_in(t, bgroup)
                        for t in (A, D, delta_bias))
    return selective_scan(u, delta, A, copy_in(B, group), copy_in(C, group),
                          D, z, delta_bias, delta_softplus)
