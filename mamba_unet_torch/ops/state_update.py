"""Single-token SSM state update for autoregressive decode.

Port of ``mamba_unet_tpu/ops/state_update.py::selective_state_update``: one
recurrence step on a cached fp32 state, in plain tensor ops as in the JAX
package (no kernel there either)::

    delta = softplus(delta + delta_bias)
    state = exp(delta*A) * state + delta * B * u
    y     = <C, state> + D*u ;  y *= silu(z)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def selective_state_update(
    state: torch.Tensor,   # (B, D, N) fp32
    u: torch.Tensor,       # (B, D)
    delta: torch.Tensor,   # (B, D)
    A: torch.Tensor,       # (D, N)
    B: torch.Tensor,       # (B, N)
    C: torch.Tensor,       # (B, N)
    D: Optional[torch.Tensor] = None,           # (D,)
    z: Optional[torch.Tensor] = None,           # (B, D)
    delta_bias: Optional[torch.Tensor] = None,  # (D,)
    delta_softplus: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, D) in u.dtype, new fp32 state); ``state`` is not
    changed."""
    u_f = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None]
    if delta_softplus:
        delta = F.softplus(delta)
    dA = torch.exp(delta[..., None] * A.float()[None])          # (B, D, N)
    dBu = delta[..., None] * B.float()[:, None, :] * u_f[..., None]
    new_state = dA * state.float() + dBu
    y = torch.einsum("bdn,bn->bd", new_state, C.float())
    if D is not None:
        y = y + u_f * D.float()[None]
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype), new_state
