"""VSS blocks and stages of the visual-Mamba UNet.

Port of ``mamba_unet_tpu/nn/vss.py``. Where the JAX model applies the
stage's down/upsample op itself, here the stage owns it (``downsample`` /
``upsample``), so the parameter names match the upstream torch checkpoints
(``layers.{i}.downsample.*``, ``layers_up.{i}.upsample.*``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mamba_unet_torch.nn.layers import DropPath
from mamba_unet_torch.nn.patch_ops import PatchExpand2D, PatchMerging2D
from mamba_unet_torch.nn.ss2d import SS2D


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))). Single branch, no MLP."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 scan_impl: str = "auto", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.self_attention = SS2D(hidden_dim, scan_impl=scan_impl,
                                   device=device, generator=generator)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop_path(self.self_attention(self.ln_1(x)))


class VSSLayer(nn.Module):
    """depth x VSSBlock, then an optional PatchMerging2D (encoder stage) or
    PatchExpand2D (decoder stage)."""

    def __init__(self, dim: int, depth: int, drop_path: Sequence[float] = (),
                 downsample: bool = False, upsample: bool = False,
                 scan_impl: str = "auto", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            VSSBlock(dim, drop_path[i] if i < len(drop_path) else 0.0,
                     scan_impl, device=device, generator=generator)
            for i in range(depth))
        self.downsample = (PatchMerging2D(dim, device=device,
                                          generator=generator)
                           if downsample else None)
        self.upsample = (PatchExpand2D(dim, device=device, generator=generator)
                         if upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        if self.downsample is not None:
            x = self.downsample(x)
        if self.upsample is not None:
            x = self.upsample(x)
        return x
