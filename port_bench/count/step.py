"""The work of one training step of a cell, counted on the plain reference
on the meta device (shapes only, nothing computed).

``FlopCounterMode`` counts the matrix products and convolutions of the
reference's forward and backward (the traffic's method's ``loss``), as autograd differentiates it; each
scan call, which it does not see, is replaced by a stand-in of the same
operands and gradient paths whose elementwise work it does not count,
and adds :func:`count.scan.flops` (a call under grad also its backward).
The scan calls' least time sums :func:`count.scan.least_s` at the
compute dtype's width.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.count import scan as scan_count
from port_bench.reference.net import param_spec
from port_bench.reference.train import method

META = torch.device("meta")


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, _transposed, _output_padding,
                         _groups, output_mask, out_shape=None) -> int:
    """The gradients of a convolution (of its input and of its weight),
    each the forward's 2 * out * (cin / groups) * kernel FLOPs; the
    counter's own formula leaves the groups out, which overcounts a
    depthwise convolution by its channel count."""
    fwd = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def step_cost(cfg: dict, traffic: dict) -> Dict[str, float]:
    """``flops`` per step (products and scans), ``scan_flops``,
    ``scan_least_s`` and ``scan_calls``."""
    calls: List[Tuple[int, int, int, int, bool]] = []

    def stand_in(u2, delta4, A, B4, C4, D, bias):
        bsz, _, L, d = delta4.shape
        calls.append((bsz, L, d, A.shape[-1], torch.is_grad_enabled()))
        return (u2.float() * D[:d] + delta4[:, :2].float() + bias[:d]
                + (B4 * C4).sum(-1, keepdim=True)[:, :2] + A.sum() * 0)

    P = {name: torch.empty(shape, device=META, requires_grad=True)
         for name, shape, _, _ in param_spec(cfg)}
    bsz = traffic["batch_size"]
    h, w = traffic["patch_size"]
    batch = {"image": torch.empty(bsz, h, w, 1, device=META),
             "label": torch.zeros(bsz, h, w, dtype=torch.long, device=META)}
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward_flops}
    ) as counter:
        loss = method(traffic).loss(cfg, traffic, P, batch, stand_in)
        loss.backward()
    itemsize = 2 if traffic["bf16"] else 4
    sflops = sum(scan_count.flops(b, L, d, n, False)
                 + (scan_count.flops(b, L, d, n, True) if g else 0)
                 for b, L, d, n, g in calls)
    least = sum(scan_count.least_s(b, L, d, n, itemsize, False)
                + (scan_count.least_s(b, L, d, n, itemsize, True) if g else 0)
                for b, L, d, n, g in calls)
    return {"flops": float(counter.get_total_flops() + sflops),
            "scan_flops": float(sflops), "scan_least_s": least,
            "scan_calls": len(calls)}
