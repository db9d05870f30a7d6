"""Swin-UNet: the transformer baseline with VSSM's UNet topology.

Port of ``mamba_unet_tpu/models/swin_unet.py`` (``SwinUnetSys`` and the
grey-input wrapper ``SwinUnet``, registered as ``ViT_seg``). Configuration
(swin_tiny_patch4_window7_224_lite): embed 96, depths (2, 2, 2, 2), heads
(3, 6, 12, 24), window 7, mlp_ratio 4, drop_path 0.2; the decoder stages
reuse their mirrored encoder stages' depths, heads and drop-path rates.
The model is built for one ``img_size``: each block's window, shift and
mask follow its stage's map (``nn/swin.py``). Module names follow the
upstream torch checkpoints, with ``SwinUnet`` holding the network as
``swin_unet``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import Dropout, lecun_normal_, linear
from mamba_unet_torch.nn.patch_ops import (
    FinalPatchExpand2D,
    PatchEmbed2D,
    PatchExpand2D,
)
from mamba_unet_torch.nn.swin import SwinStage


class SwinUnetSys(nn.Module):
    def __init__(self, img_size: int = 224, num_classes: int = 4,
                 in_chans: int = 3, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(depths)
        kw = dict(device=device, generator=generator)
        dims = [embed_dim * 2 ** i for i in range(n)]
        res = [img_size // patch_size // 2 ** i for i in range(n)]
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        offs = np.cumsum([0, *depths]).tolist()
        stage_dpr = [dpr[offs[i]:offs[i + 1]] for i in range(n)]

        def stage(i, **updown):
            return SwinStage(dims[i], (res[i], res[i]), depths[i],
                             num_heads[i], window_size, mlp_ratio, drop_rate,
                             attn_drop_rate, stage_dpr[i], **updown, **kw)

        self.patch_embed = PatchEmbed2D(patch_size, in_chans, embed_dim, **kw)
        self.pos_drop = Dropout(drop_rate)
        self.layers = nn.ModuleList(stage(i, downsample=i < n - 1)
                                    for i in range(n))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-5, device=device)
        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for i in range(n):
            mirror = n - 1 - i
            if i == 0:
                self.layers_up.append(PatchExpand2D(dims[-1], **kw))
                self.concat_back_dim.append(nn.Identity())
            else:
                self.concat_back_dim.append(linear(
                    2 * dims[mirror], dims[mirror], True, device, generator))
                self.layers_up.append(stage(mirror, upsample=i < n - 1))
        self.norm_up = nn.LayerNorm(dims[0], eps=1e-5, device=device)
        self.up = FinalPatchExpand2D(dims[0], patch_size, **kw)
        self.output = nn.Conv2d(dims[0], num_classes, 1, bias=False,
                                device=device)
        lecun_normal_(self.output.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pos_drop(self.patch_embed(x))
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x)
        x = self.norm(x)
        for i, layer in enumerate(self.layers_up):
            if i > 0:
                x = self.concat_back_dim[i](torch.cat([x, skips[-1 - i]], -1))
            x = layer(x)
        x = self.up(self.norm_up(x))
        # the 1x1 conv head is a pointwise linear on the channel axis
        return F.linear(x, self.output.weight.flatten(1)).float()


class SwinUnet(nn.Module):
    """Grey-input wrapper: a 1-channel input is repeated to 3 channels,
    then runs :class:`SwinUnetSys`."""

    def __init__(self, num_classes: int = 4, img_size: int = 224,
                 in_chans: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, drop_path_rate: float = 0.2, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.swin_unet = SwinUnetSys(
            img_size, num_classes, 3 if in_chans == 1 else in_chans,
            embed_dim=embed_dim, depths=depths, num_heads=num_heads,
            window_size=window_size, drop_path_rate=drop_path_rate,
            device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        return self.swin_unet(x)
