"""The work of one bidirectional scan call, from its shapes.

``flops`` - the selective scan's analytical count (the formula of the
Mamba reference's ``flops_selective_scan_ref``: 9 B L D N for the core
plus B D L for the D skip, here over the 4 directions' B * 4 * L * D
lanes); a backward counts twice its forward.

``least_s`` - the least time of a call on the card: the larger of its
bytes at the HBM rate and its operations at the exp and fp32 rates.
Each input is read once and each output written once, at the call's
shapes: u2 (B, 2, L, D), delta4 (B, 4, L, D), B4 and C4 (B, 4, L, N) in
the compute dtype, A (4D, N), D and the dt bias (4D) in fp32, the
pair-summed y (B, 2, L, D) in fp32; the backward reads the inputs and the
cotangent of y and writes a gradient of every input. Per (direction,
step, channel, state) the forward needs 1 exp and ~6 FLOPs and the
backward 1 exp and ~20; the softplus and its derivative add 2 and 5
special-function results per (direction, step, channel). Nothing that an
implementation chooses to save or recompute is counted.
"""

from __future__ import annotations

from port_bench.count.peaks import (
    FP32_FLOP_PER_S,
    HBM_BYTES_PER_S,
    SFU_PER_S,
)


def selective_scan_flops(B: int, L: int, D: int, N: int,
                         with_D: bool = True) -> int:
    return 9 * B * L * D * N + (B * D * L if with_D else 0)


def flops(bsz: int, L: int, d: int, n: int, backward: bool) -> int:
    f = selective_scan_flops(bsz * 4, L, d, n)
    return 2 * f if backward else f


def least_s(bsz: int, L: int, d: int, n: int, itemsize: int,
            backward: bool) -> float:
    trip = bsz * 4 * L * d
    io_in = (bsz * 2 * L * d + bsz * 4 * L * d + 2 * bsz * 4 * L * n) \
        * itemsize
    params = 4 * d * (n + 2) * 4
    y = bsz * 2 * L * d * 4
    if backward:
        nbytes = 2 * io_in + 2 * params + y
        exps, fl = trip * (n + 5), trip * n * 20
    else:
        nbytes = io_in + params + y
        exps, fl = trip * (n + 2), trip * n * 6
    return max(nbytes / HBM_BYTES_PER_S, exps / SFU_PER_S,
               fl / FP32_FLOP_PER_S)
