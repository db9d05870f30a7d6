"""VSSM — the UNet-shaped visual-Mamba segmentation network (Mamba-UNet).

Port of ``mamba_unet_tpu/models/vssm.py`` (``VSSM`` and ``MambaUnet``).
Topology, for depths (2, 2, 2, 2) and dims (96, 192, 384, 768)::

  patch_embed (x4 down)
  encoder: 4 stages, skip captured BEFORE each stage, PatchMerging after
           each stage but the last
  norm
  decoder: PatchExpand, then 3 stages of [concat skip -> Linear 2C->C ->
           VSS blocks -> PatchExpand (except the last)]
  norm_up -> FinalPatchExpand (x4 up) -> 1x1 conv head

All tensors are channels-last; logits come out fp32 as (B, H, W, classes).
``scan_impl`` picks every SS2D's scan branch (``nn/ss2d.py``).
Module names follow the upstream torch checkpoints, with ``MambaUnet``
holding the network as ``mamba_unet``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import lecun_normal_, linear
from mamba_unet_torch.nn.patch_ops import (
    FinalPatchExpand2D,
    PatchEmbed2D,
    PatchExpand2D,
)
from mamba_unet_torch.nn.vss import VSSLayer

PATCH_SIZE = 4  # patch embedding stride and final expand scale


class VSSM(nn.Module):
    def __init__(self, num_classes: int = 4, in_chans: int = 3,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.2, scan_impl: str = "auto", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(depths)
        kw = dict(scan_impl=scan_impl, device=device, generator=generator)
        # stochastic depth: linear 0 -> drop_path_rate over the encoder
        # blocks; each decoder stage reuses its mirrored encoder stage's rates
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        offs = np.cumsum([0, *depths]).tolist()
        stage_dpr = [dpr[offs[i]:offs[i + 1]] for i in range(n)]

        self.patch_embed = PatchEmbed2D(PATCH_SIZE, in_chans, dims[0],
                                        device=device, generator=generator)
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], depths[i], stage_dpr[i], downsample=i < n - 1,
                     **kw)
            for i in range(n))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-5, device=device)

        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for i in range(n):
            mirror = n - 1 - i
            if i == 0:
                self.layers_up.append(PatchExpand2D(
                    dims[-1], device=device, generator=generator))
                self.concat_back_dim.append(nn.Identity())
            else:
                self.concat_back_dim.append(linear(
                    2 * dims[mirror], dims[mirror], True, device, generator))
                self.layers_up.append(VSSLayer(
                    dims[mirror], depths[mirror], stage_dpr[mirror],
                    upsample=i < n - 1, **kw))
        self.norm_up = nn.LayerNorm(dims[0], eps=1e-5, device=device)
        self.up = FinalPatchExpand2D(dims[0], PATCH_SIZE, device=device,
                                     generator=generator)
        self.output = nn.Conv2d(dims[0], num_classes, 1, bias=False,
                                device=device)
        lecun_normal_(self.output.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
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


class MambaUnet(nn.Module):
    """Grey-input wrapper: a 1-channel input is repeated to 3 channels (the
    pretrained patch embedding expects RGB), then runs :class:`VSSM`."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.2, scan_impl: str = "auto", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mamba_unet = VSSM(num_classes, 3 if in_chans == 1 else in_chans,
                               depths=depths, dims=dims,
                               drop_path_rate=drop_path_rate,
                               scan_impl=scan_impl, device=device,
                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        return self.mamba_unet(x)
