"""The rule that holds a training kernel's output against its plain version,
and the model gradients that are exact zeros.

``chip_smoke.py`` and the card tests (``tests/test_torch_kernel.py``) both
use them, so the two hold the kernels and models to the same tolerance.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

# one bf16 rounding step, relative to the value: 8 significant bits
BF16_STEP = 2.0 ** -7
# the bias of a convolution that feeds a train-mode BatchNorm has an exact
# zero gradient (the normalisation removes any per-channel shift), so what
# is computed is rounding noise, to be compared with no own magnitude; it
# is held below this share of its model's largest gradient on both sides
ZERO_GRAD_REL = 1e-5


def assert_close_to_max(got: torch.Tensor, want: torch.Tensor, rel: float,
                        what: str) -> float:
    """Raise ``AssertionError`` unless ``got`` is finite, has ``want``'s
    shape and dtype, and |got - want| <= rel * max|want| elementwise, plus
    one bf16 rounding step of ``want`` where the output is bf16 (both
    versions round an fp32 sum to bf16). Returns the max abs error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = rel * w.abs().max()
    if want.dtype == torch.bfloat16:
        bound = bound + BF16_STEP * w.abs()
    if not (bool(torch.isfinite(g).all()) and bool((err <= bound).all())):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e}, "
                             f"ref max {w.abs().max().item():.3e}")
    return err.max().item()


def batchnorm_fed_biases(model: nn.Module) -> List[str]:
    """The parameter names of the biases of the convolutions whose output
    an ``nn.Sequential`` hands straight to a BatchNorm (the UNet family's
    conv blocks): exact zeros of the gradient in train mode."""
    names = []
    for prefix, module in model.named_modules():
        if not isinstance(module, nn.Sequential):
            continue
        children = list(module.named_children())
        for (name, conv), (_, norm) in zip(children, children[1:]):
            if (isinstance(conv, nn.Conv2d) and conv.bias is not None
                    and isinstance(norm, nn.BatchNorm2d)):
                names.append(f"{prefix}.{name}.bias" if prefix
                             else f"{name}.bias")
    return names
