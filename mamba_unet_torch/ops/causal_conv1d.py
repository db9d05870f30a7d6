"""Depthwise causal 1-D convolution and its single-token decode update.

Port of ``mamba_unet_tpu/ops/causal_conv1d.py``. The JAX package computes
these with ``lax.conv_general_dilated`` and an einsum, not with Pallas
kernels; here they are ``F.conv1d`` with one group per channel and tensor
ops. Math is fp32 whatever the input dtype; outputs take the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _check_activation(activation: Optional[str]) -> None:
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
) -> torch.Tensor:
    """x: (B, D, L), weight: (D, W), bias: (D,). Causal: left pad W-1."""
    _check_activation(activation)
    d, width = weight.shape
    out = F.conv1d(F.pad(x.float(), (width - 1, 0)),
                   weight.float()[:, None, :],
                   None if bias is None else bias.float(), groups=d)
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype)


def causal_conv1d_update(
    x: torch.Tensor,
    conv_state: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
):
    """One decode step. x: (B, D); conv_state: (B, D, W), the last W
    inputs, oldest first. Returns (out (B, D), new conv_state); the state
    passed in is not changed."""
    _check_activation(activation)
    state = torch.cat([conv_state[..., 1:], x[..., None].to(conv_state.dtype)],
                      dim=-1)
    out = (state.float() * weight.float()).sum(-1)
    if bias is not None:
        out = out + bias.float()
    if activation is not None:
        out = F.silu(out)
    return out.to(x.dtype), state
