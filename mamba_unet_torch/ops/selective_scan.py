"""Selective scan (S6) reference: a sequential fp32 loop over time.

Port of ``mamba_unet_tpu/ops/selective_scan.py::selective_scan_ref`` (with
its ``_prep``/``_finalize`` semantics). It is the ground truth that the CUDA
kernel is held against, and the scan that CPU tensors run::

    delta = softplus(delta + delta_bias)            (both optional)
    x_t   = exp(delta_t * A) * x_{t-1} + delta_t * B_t * u_t     (x_0 = 0)
    y_t   = <C_t, x_t> + D * u_t

Shapes (grouped B/C: channel block g of D shares B/C group g)::

    u, delta   : (B, D, L)
    A          : (D, N)
    B, C       : (B, G, N, L)   or (B, N, L) for G = 1
    D, delta_bias : (D,) or None

The state and all arithmetic are fp32 whatever the input dtype; the output
takes the dtype of ``u``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
    delta_bias: Optional[torch.Tensor] = None,
    delta_softplus: bool = False,
) -> torch.Tensor:
    """Sequential reference scan -> (B, D, L) in ``u.dtype``."""
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
    x = u_f.new_zeros(bsz, G, dg, n)
    ys = []
    for t in range(L):
        d_t = delta_g[..., t, None]                                # (B,G,dg,1)
        x = torch.exp(d_t * A_g) * x + (
            d_t * B_f[:, :, None, :, t] * u_g[..., t, None])      # (B,G,dg,n)
        ys.append(torch.einsum("bgdn,bgn->bgd", x, C_f[..., t]))
    y = torch.stack(ys, dim=-1).reshape(bsz, dim, L)
    if D is not None:
        y = y + u_f * D.float()[None, :, None]
    return y.to(out_dtype)
