"""The bidirectional selective scan of SS2D, as a sequential loop.

Two data streams u2 = [row-major, column-major] (B, 2, L, d) are each
scanned forward and backward in time: direction k reads stream k % 2,
and directions 2 and 3 run in reversed time. Direction k has its own
rows of A (k*d .. (k+1)*d), D and the dt bias; delta4, B4 and C4
(B, 4, L, .) are given in data order. Per direction and step

    dt  = softplus(delta + bias)
    x_t = exp(dt A) x_{t-1} + dt B_t u_t        (state (d, N), x_0 = 0)
    y_t = <x_t, C_t> + D u_t

and the output, in data order and fp32, is the pair sum
out[:, m] = y_m + y_{m+2} (VMamba's SS2D, Liu et al. 2024; Mamba's
selective scan, Gu and Dao 2023). Everything is computed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _scan_order(x: torch.Tensor) -> torch.Tensor:
    """(B, 4, L, ...) data order <-> scan order (directions 2, 3 flipped)."""
    return torch.cat([x[:, :2], x[:, 2:].flip(2)], dim=1)


class LinearRecurrence(torch.autograd.Function):
    """X[:, :, t] = a[:, :, t] * X[:, :, t - 1] + b[:, :, t] over the time
    axis 2, X[:, :, -1] = 0. The backward runs the adjoint recurrence
    h_t = g_t + a_{t+1} h_{t+1}, giving db = h and da_t = h_t X_{t-1}: a
    time loop of one product per step each way, where autograd through a
    loop of slices would build a full-size gradient for every slice."""

    @staticmethod
    def forward(ctx, a, b):
        X = torch.empty_like(b)
        x = torch.zeros_like(b[:, :, 0])
        for t in range(b.shape[2]):
            x = torch.addcmul(b[:, :, t], a[:, :, t], x)
            X[:, :, t] = x
        ctx.save_for_backward(a, X)
        return X

    @staticmethod
    def backward(ctx, g):
        a, X = ctx.saved_tensors
        L = g.shape[2]
        H = torch.empty_like(g)
        h = g[:, :, L - 1]
        H[:, :, L - 1] = h
        for t in range(L - 2, -1, -1):
            h = torch.addcmul(g[:, :, t], a[:, :, t + 1], h)
            H[:, :, t] = h
        ga = torch.zeros_like(a)
        ga[:, :, 1:] = H[:, :, 1:] * X[:, :, :-1]
        return ga, H


def scan_bidir(u2, delta4, A, B4, C4, D, delta_bias):
    """fp32 (B, 2, L, d): the pair-summed outputs (module docstring)."""
    bsz, _, L, d = delta4.shape
    n = A.shape[-1]
    u4 = _scan_order(torch.cat([u2, u2], dim=1).float())
    d4 = _scan_order(delta4.float())
    b4 = _scan_order(B4.float())
    c4 = _scan_order(C4.float())
    dt = F.softplus(d4 + delta_bias.float().reshape(1, 4, 1, d))
    dA = torch.exp(dt[..., None] * A.float().reshape(1, 4, 1, d, n))
    dBu = (dt * u4)[..., None] * b4[:, :, :, None, :]      # (B,4,L,d,N)
    X = LinearRecurrence.apply(dA, dBu)                     # (B,4,L,d,N)
    y = torch.einsum("bgldn,bgln->bgld", X, c4) + u4 * D.float().reshape(
        1, 4, 1, d)
    y = _scan_order(y)
    return y[:, :2] + y[:, 2:]
