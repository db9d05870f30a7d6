"""Sequence-sharded selective scan: L split over a mesh axis.

Port of ``mamba_unet_tpu/parallel/seq_scan.py``. Each rank holds one
contiguous L shard of u/Δ/B/C/z. The shards may differ in length by one
(``parallel.comm.scatter_in`` cuts as ``torch.tensor_split``), where
JAX's ``shard_map`` needs L divisible by the axis size: the full-width
Mamba-UNet's last stage has 49 tokens. Because a_t = exp(Δ_t A), a shard's decay
aggregate needs no scan::

    a_prod_i   = exp(A * sum_t Δ_t)               (per B, D, N; this shard)
    state_i    = the shard's last state from a zero state (first pass)
    carry_in_i = combine_{k<i} (a_prod_k, state_k)  (exclusive prefix:
                 c <- a_prod_k * c + state_k over k = 0 .. i-1)
    y_i        = the shard's scan from x_init = carry_in_i (second pass)

Both passes are the public scan (``ops/selective_scan.py``): on CUDA
tensors the grouped kernels #3/#3s and #4u, whose training forward returns a
last state that carries a gradient and whose backward returns the incoming
state's gradient; on CPU tensors the plain loop. The (B, D, N) pairs are
all-gathered differentiably (``parallel/comm.py``), so the gradient of a
shard's state collects the contributions of every later shard. A, D and
Δbias are replicated: their gradients are summed over the axis in the
backward, as JAX's ``shard_map`` transposes its replicated inputs.

Usage: call :func:`selective_scan_seq_sharded` on this rank's shards, or
run ``SS2D(scan_impl="seq_sharded")`` inside :class:`sequence_sharding`.
"""

from __future__ import annotations

import contextvars

import torch

from mamba_unet_torch.ops.selective_scan import _prep, selective_scan
from mamba_unet_torch.parallel.comm import all_gather_stack, copy_in
from mamba_unet_torch.parallel.mesh import Mesh

_SEQ_CTX: contextvars.ContextVar = contextvars.ContextVar("seq_sharding",
                                                          default=None)


class sequence_sharding:
    """Context manager enabling sequence-parallel scans inside models::

        with sequence_sharding(mesh, "seq"):
            y = model(x)        # SS2D(scan_impl="seq_sharded")
    """

    def __init__(self, mesh: Mesh, axis: str = "seq"):
        self.ctx = (mesh, axis)

    def __enter__(self):
        self._token = _SEQ_CTX.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _SEQ_CTX.reset(self._token)
        return False


def current_sequence_sharding():
    """(mesh, axis) of the active :class:`sequence_sharding`, or None."""
    return _SEQ_CTX.get()


def exclusive_prefix(all_a: torch.Tensor, all_s: torch.Tensor,
                     index: int) -> torch.Tensor:
    """The carry entering shard ``index``: the (a, state) pairs of shards
    0 .. index-1 combined in order (zero for shard 0). Every pair enters
    the graph, those of shards >= ``index`` with weight 0 (as JAX's
    masked loop), so that every rank's backward reaches the gather and
    runs its collective."""
    carry = torch.zeros_like(all_s[0])
    for k in range(all_a.shape[0]):
        use = 1.0 if k < index else 0.0
        carry = (use * all_a[k] + (1.0 - use)) * carry + use * all_s[k]
    return carry


def selective_scan_seq_sharded(
    u, delta, A, B, C,
    D=None, z=None, delta_bias=None, delta_softplus: bool = False,
    *, mesh: Mesh, axis: str = "seq",
):
    """Selective scan of this rank's L shard of u/delta/z (B, D, L_shard)
    and B/C (B, G, N, L_shard) or (B, N, L_shard), with the parameters A,
    D, delta_bias replicated over ``mesh[axis]``. Returns this rank's shard
    of y, in the dtype of ``u`` (JAX's ``chunk``, its XLA scan's chunk
    length, has no counterpart: the kernels take the shard whole)."""
    group = mesh.group(axis)
    index = mesh.index(axis)
    A = copy_in(A, group)
    D = None if D is None else copy_in(D, group)
    delta_bias = None if delta_bias is None else copy_in(delta_bias, group)

    # the local decay aggregate and the last state from a zero state
    _, delta_f, A_f, _, _ = _prep(u, delta, A, B, C, delta_bias,
                                  delta_softplus)
    a_prod = torch.exp(delta_f.sum(-1)[..., None] * A_f[None])  # (B, D, N)
    _, state = selective_scan(u, delta, A, B, C, None, None, delta_bias,
                              delta_softplus, return_last_state=True)

    # exclusive prefix across the axis over the gathered (B, D, N) pairs
    carry = exclusive_prefix(all_gather_stack(a_prod, group),
                             all_gather_stack(state, group), index)
    return selective_scan(u, delta, A, B, C, D, z, delta_bias,
                          delta_softplus, x_init=carry)
