"""VSS blocks and stages of the visual-Mamba UNet.

Port of ``mamba_unet_tpu/nn/vss.py``. Where the JAX model applies the
stage's down/upsample op itself, here the stage owns it (``downsample`` /
``upsample``), so the parameter names match the upstream torch checkpoints
(``layers.{i}.downsample.*``, ``layers_up.{i}.upsample.*``).
``use_remat`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat(VSSBlock)``
does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mamba_unet_torch.nn.layers import DropPath
from mamba_unet_torch.nn.patch_ops import PatchExpand2D, PatchMerging2D
from mamba_unet_torch.nn.ss2d import SS2D


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))). Single branch, no MLP. With ``use_remat``
    and grad enabled, the block's activations are recomputed in the
    backward instead of kept."""

    def __init__(self, hidden_dim: int, drop_path: float = 0.0,
                 scan_impl: str = "auto", use_remat: bool = False,
                 d_state: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_remat = use_remat
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-5, device=device)
        self.self_attention = SS2D(hidden_dim, d_state, scan_impl=scan_impl,
                                   device=device, generator=generator)
        self.drop_path = DropPath(drop_path)

    def _residual(self, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x + self.drop_path(self.self_attention(self.ln_1(x)), mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.use_remat and torch.is_grad_enabled()):
            return self._residual(x)
        # the DropPath mask is drawn once, here: checkpoint restores the
        # global RNGs for the recomputation, not DropPath's own generator
        return checkpoint(self._residual, x, self.drop_path.draw(x),
                          use_reentrant=False)


class VSSLayer(nn.Module):
    """depth x VSSBlock, then an optional PatchMerging2D (encoder stage) or
    PatchExpand2D (decoder stage)."""

    def __init__(self, dim: int, depth: int, drop_path: Sequence[float] = (),
                 downsample: bool = False, upsample: bool = False,
                 scan_impl: str = "auto", use_remat: bool = False,
                 d_state: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = nn.ModuleList(
            VSSBlock(dim, drop_path[i] if i < len(drop_path) else 0.0,
                     scan_impl, use_remat, d_state, device=device,
                     generator=generator)
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
