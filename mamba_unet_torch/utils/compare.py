"""The rule that holds a training kernel's output against its plain version.

``chip_smoke.py`` and the card tests (``tests/test_torch_kernel.py``) both
use it, so the two hold the kernels to the same tolerance.
"""

from __future__ import annotations

import torch

# one bf16 rounding step, relative to the value: 8 significant bits
BF16_STEP = 2.0 ** -7


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
