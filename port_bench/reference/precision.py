"""Where the reference rounds: its matrix products and convolutions.

``Precision("fp32")`` computes every product in float32 (the caller turns
TF32 off). ``Precision("fp8")`` is the control: the operands of every
product rounded to float8 e4m3 with one scale per tensor (its largest
magnitude mapped to 448), as an fp8 GEMM takes them, the product
accumulated in float32. The rounding passes its gradient straight
through, so the backward's products see the rounded operands that the
forward saved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with a per-tensor scale; gradient straight
    through."""
    xd = x.detach()
    scale = E4M3_MAX / xd.abs().amax().clamp_min(1e-30)
    r = (xd * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (r - xd)


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.name == "fp8" else x

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def conv2d(self, x, w, b=None, **kw):
        return F.conv2d(self.q(x), self.q(w), b, **kw)
