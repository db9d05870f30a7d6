"""Selective scan (S6): the plain fp32 loop, its plain backward and the
public dispatcher.

Port of ``mamba_unet_tpu/ops/selective_scan.py``: ``selective_scan_ref``
(with its ``_prep``/``_finalize`` semantics) and the public
:func:`selective_scan`; :func:`selective_scan_ref_bwd` is the reverse-time
loop that every scan's plain backward runs. ``selective_scan_xla`` cuts L
into chunks and carries the fp32 state across them; a sequential fp32 loop
gives the same outputs in one piece, so :func:`selective_scan_ref` stands
for both::

    delta = softplus(delta + delta_bias)            (both optional)
    x_t   = exp(delta_t * A) * x_{t-1} + delta_t * B_t * u_t
            (x_{-1} = x_init, or 0)
    y_t   = <C_t, x_t> + D * u_t
    out   = y * silu(z)                             (if z is given)

Shapes (grouped B/C: channel block g of D shares B/C group g)::

    u, delta, z   : (B, D, L)
    A             : (D, N)
    B, C          : (B, G, N, L)   or (B, N, L) for G = 1
    D, delta_bias : (D,) or None
    x_init        : (B, D, N) or None: the incoming state (the carry of
                    a sequence-sharded scan, ``parallel/seq_scan.py``)

The state and all arithmetic are fp32 whatever the input dtype; the output
takes the dtype of ``u``; the last state, when asked for, is fp32
(B, D, N).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mamba_unet_torch.ops.selective_scan_grouped import (
    selective_scan_grouped,
    silu_gate,
)


def _canon_bc(x: torch.Tensor) -> torch.Tensor:
    """(B, N, L) -> (B, 1, N, L); (B, G, N, L) passes through."""
    if x.dim() == 3:
        return x[:, None]
    if x.dim() != 4:
        raise ValueError(f"B/C must be rank 3 or 4, got shape {tuple(x.shape)}")
    return x


def _prep(u, delta, A, B, C, delta_bias, delta_softplus):
    u = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    return u, delta, A.float(), _canon_bc(B).float(), _canon_bc(C).float()


def selective_scan_ref(
    u: torch.Tensor,
    delta: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    *,
    state_chunk: int = 0,
    x_init: Optional[torch.Tensor] = None,
):
    """Sequential reference scan -> (B, D, L) in ``u.dtype``, and with
    ``return_last_state`` also the fp32 (B, D, N) state after step L. The
    scan starts from ``x_init`` (B, D, N), or from zero. With
    ``state_chunk`` = k > 0 it also returns, last, the fp32 states entering
    steps 0, k, 2k, ... as (B, ceil(L / k), D, N): the chunk-entry states
    that a training forward saves for its backward."""
    out_dtype = u.dtype
    u_f, delta_f, A_f, B_f, C_f = _prep(u, delta, A, B, C, delta_bias,
                                        delta_softplus)
    bsz, dim, L = u_f.shape
    G = B_f.shape[1]
    n = A_f.shape[1]
    dg = dim // G

    A_g = A_f.reshape(G, dg, n)
    u_g = u_f.reshape(bsz, G, dg, L)
    delta_g = delta_f.reshape(bsz, G, dg, L)
    x = (u_f.new_zeros(bsz, G, dg, n) if x_init is None
         else x_init.float().reshape(bsz, G, dg, n))
    ys, states = [], []
    for t in range(L):
        if state_chunk and t % state_chunk == 0:
            states.append(x.reshape(bsz, dim, n))
        d_t = delta_g[..., t, None]                                # (B,G,dg,1)
        x = torch.exp(d_t * A_g) * x + (
            d_t * B_f[:, :, None, :, t] * u_g[..., t, None])      # (B,G,dg,n)
        ys.append(torch.einsum("bgdn,bgn->bgd", x, C_f[..., t]))
    y = torch.stack(ys, dim=-1).reshape(bsz, dim, L)
    if D is not None:
        y = y + u_f * D.float()[None, :, None]
    out = y.to(out_dtype) if z is None else silu_gate(y, z, out_dtype)
    extra = ((x.reshape(bsz, dim, n),) if return_last_state else ()) + (
        (torch.stack(states, dim=1),) if state_chunk else ())
    return (out, *extra) if extra else out


def selective_scan_ref_bwd(u, delta, A, B, C, D, delta_bias, delta_softplus,
                           gy, x_init=None, g_last=None):
    """Plain backward of :func:`selective_scan_ref` (without ``z``) for the
    cotangent ``gy`` of its output and ``g_last`` (B, D, N) of its last
    state (None: zero): the forward loop, from ``x_init`` or zero, keeps
    the state entering every step, then one loop backwards in time carries
    the state's cotangent. Returns fp32 (du, ddelta, dA, dB, dC, dD,
    ddelta_bias) in the operands' shapes, and with an ``x_init`` last also
    dx_init, the cotangent carried past step 0; dD and ddelta_bias are None
    for a missing D or delta_bias. It needs no autograd, so the training
    ops' CPU implementations, which run below autograd, can call it."""
    u_f, dt, A_f, B_f, C_f = _prep(u, delta, A, B, C, delta_bias,
                                   delta_softplus)
    bsz, dim, L = u_f.shape
    G, n = B_f.shape[1], A_f.shape[1]
    dg = dim // G
    A_g = A_f.reshape(G, dg, n)
    u_g = u_f.reshape(bsz, G, dg, L)
    dt_g = dt.reshape(bsz, G, dg, L)
    gy_g = gy.float().reshape(bsz, G, dg, L)
    D_g = (torch.zeros(G, dg) if D is None else D.float().reshape(G, dg)
           ).to(u_f.device)
    x = (u_f.new_zeros(bsz, G, dg, n) if x_init is None
         else x_init.float().reshape(bsz, G, dg, n))
    entering = []
    for t in range(L):
        entering.append(x)
        d_t = dt_g[..., t, None]
        x = torch.exp(d_t * A_g) * x + (
            d_t * B_f[:, :, None, :, t] * u_g[..., t, None])
    du, ddt = torch.empty_like(u_g), torch.empty_like(dt_g)
    dB, dC = torch.empty_like(B_f), torch.empty_like(C_f)
    dA = torch.zeros_like(A_g)
    # cotangent of the state after step t
    h = (torch.zeros_like(x) if g_last is None
         else g_last.float().reshape(bsz, G, dg, n))
    for t in reversed(range(L)):
        d_t, u_t, g_t = dt_g[..., t, None], u_g[..., t], gy_g[..., t]
        a_t = torch.exp(d_t * A_g)
        dC[..., t] = torch.einsum("bgdn,bgd->bgn", x, g_t)
        h = h + g_t[..., None] * C_f[:, :, None, :, t]
        hB = torch.einsum("bgdn,bgn->bgd", h, B_f[..., t])
        h_a_x = h * a_t * entering[t]          # d/d(a_t) times a_t
        du[..., t] = hB * d_t[..., 0] + D_g * g_t
        ddt[..., t] = (h_a_x * A_g).sum(-1) + hB * u_t
        dB[..., t] = torch.einsum("bgdn,bgd->bgn", h, d_t[..., 0] * u_t)
        dA += (h_a_x * d_t).sum(0)
        x = entering[t]
        h = h * a_t
    if delta_softplus:
        pre = delta.float().reshape(bsz, G, dg, L)
        if delta_bias is not None:
            pre = pre + delta_bias.float().reshape(G, dg, 1)
        ddt = ddt * torch.sigmoid(pre)
    ddelta = ddt.reshape(bsz, dim, L)
    dD = None if D is None else (gy_g * u_g).sum((0, 3)).reshape(dim)
    ddb = None if delta_bias is None else ddelta.sum((0, 2))
    grads = (du.reshape(bsz, dim, L), ddelta, dA.reshape(dim, n),
             dB.reshape(B.shape), dC.reshape(C.shape), dD, ddb)
    return grads if x_init is None else grads + (h.reshape(bsz, dim, n),)


def selective_scan(
    u,
    delta,
    A,
    B,
    C,
    D=None,
    z=None,
    delta_bias=None,
    delta_softplus: bool = False,
    return_last_state: bool = False,
    x_init=None,
):
    """The public selective scan on (B, D, L) inputs, from the incoming
    state ``x_init`` (B, D, N) or zero.

    CPU tensors run :func:`selective_scan_ref`. CUDA tensors go time-major
    through ``selective_scan_grouped``, which launches the CUDA kernel
    ``csrc/selective_scan_fwd.cu`` or raises, and under grad its
    state-saving variant and the backward kernel
    ``csrc/selective_scan_bwd.cu``; ``z`` gates its output here, in fp32, as
    the JAX package's Pallas wrapper does."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                  delta_softplus, return_last_state,
                                  x_init=x_init)
    bsz, dim, L = u.shape
    B, C = _canon_bc(B), _canon_bc(C)
    G = B.shape[1]
    dg = dim // G
    io = torch.bfloat16 if u.dtype == torch.bfloat16 else torch.float32

    def time_major(t, width):  # (B, G*width, L) -> (B, G, L, width)
        return t.to(io).reshape(bsz, G, width, L).transpose(2, 3).contiguous()

    zeros = torch.zeros(dim, dtype=torch.float32, device=u.device)
    out = selective_scan_grouped(
        time_major(u, dg), time_major(delta, dg), A.float().contiguous(),
        B.to(io).transpose(2, 3).contiguous(),
        C.to(io).transpose(2, 3).contiguous(),
        zeros if D is None else D.float().contiguous(),
        zeros if delta_bias is None else delta_bias.float().contiguous(),
        delta_softplus, return_last_state,
        None if x_init is None else x_init.float().contiguous())
    y, last = out if return_last_state else (out, None)
    y = y.transpose(2, 3).reshape(bsz, dim, L)
    y = y.to(u.dtype) if z is None else silu_gate(y, z, u.dtype)
    return (y, last) if return_last_state else y
