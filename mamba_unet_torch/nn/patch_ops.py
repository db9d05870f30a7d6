"""Patchify / merge / expand ops of the UNet-shaped VSS model, channels-last.

Port of ``mamba_unet_tpu/nn/patch_ops.py`` (bhwc layout only). Module and
parameter names follow the upstream torch checkpoints (``proj``, ``norm``,
``reduction``, ``expand``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mamba_unet_torch.nn.layers import lecun_normal_, linear


def depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, W, s*s*c) -> (B, s*H, s*W, c), 'b h w (p1 p2 c) -> b (h p1) (w p2) c'."""
    bsz, H, W, c = x.shape
    c //= s * s
    return x.reshape(bsz, H, W, s, s, c).permute(0, 1, 3, 2, 4, 5).reshape(
        bsz, s * H, s * W, c)


class PatchEmbed2D(nn.Module):
    """Conv patchify: (B, H, W, Cin) -> (B, H/p, W/p, embed_dim) + LayerNorm."""

    def __init__(self, patch_size: int = 4, in_chans: int = 3,
                 embed_dim: int = 96, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size, device=device)
        lecun_normal_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x)


class PatchMerging2D(nn.Module):
    """2x2 space-to-depth -> LayerNorm(4C) -> Linear 4C->2C (downsample x2).

    Sub-pixel order along channels is [(0,0), (1,0), (0,1), (1,1)]."""

    def __init__(self, dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5, device=device)
        self.reduction = linear(4 * dim, 2 * dim, False, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        x = x[:, : H - H % 2, : W - W % 2]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpand2D(nn.Module):
    """Linear C->2C -> 2x2 depth-to-space (C/2 out) -> LayerNorm (upsample x2)."""

    def __init__(self, dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.expand = linear(dim, 2 * dim, False, device, generator)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(depth_to_space(self.expand(x), 2))


class FinalPatchExpand2D(nn.Module):
    """Linear C->s*s*C -> sxs depth-to-space (C out) -> LayerNorm (upsample xs)."""

    def __init__(self, dim: int, scale: int = 4, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = scale
        self.expand = linear(dim, scale * scale * dim, False, device,
                             generator)
        self.norm = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(depth_to_space(self.expand(x), self.scale))

