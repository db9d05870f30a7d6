"""The zoo's remaining members: the map-and-image discriminators, the
ResNet-encoder UNet and the EfficientNet-encoder UNet.

Port of ``mamba_unet_tpu/models/misc_nets.py`` (the reference's
``discriminator.py``, ``pretrained_unet.py`` and ``efficientunet.py``):

* ``FCDiscriminator`` (``fc_discriminator`` 2-D, ``fc3d_discriminator``
  3-D): a 4^n/2 conv on the map and one on the image, summed, then three
  more 4^n/2 convs with leaky ReLU 0.2 and dropout 0.5, a global average
  pool and a 2-way linear head. ``forward(seg_map, image)``.
* ``PreUNet`` (``preUnet``): a 7x7/2 stem, a 3x3/2 max pool and bottleneck
  ResNet stages of widths 64/128/256 (x4 out), decoded by conv pairs
  (3x3 conv, BatchNorm, leaky ReLU 0.01) and bilinear x2 upsampling with
  two skips.
* ``EffiUNet`` (``efficient_unet``): a 3x3/2 stem and MBConv stages
  (1x1 expand x4, 3x3 depthwise, squeeze-excite, 1x1 project; residual
  where the shape allows) decoded by bilinear x2 + skip + conv pairs.

The BatchNorms are flax's (``nn/layers.py``); the bilinear x2 resize is
``F.interpolate(align_corners=False)``, which equals ``jax.image.resize``
there. Images come in channels-last, (B, H, W, C) (the 3-D discriminator
(B, D, H, W, C)), and outputs go out as fp32 (logits channels-last).
Module names are the flax module's, so ``utils/convert.py`` maps them one
to one; dropout draws from the generator the trainer hands every
``Drawing`` module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.segmamba import check_rank
from mamba_unet_torch.models.vnet import (
    channels_first,
    channels_last,
    conv,
    dense,
)
from mamba_unet_torch.nn.layers import BatchNorm2d, Dropout, leaky_relu


class FCDiscriminator(nn.Module):
    """Map + image discriminator -> (B, 2) logits."""

    def __init__(self, num_classes: int, ndf: int = 64, ndim: int = 2,
                 in_chans: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(stride=2, padding=1, device=device, generator=generator)
        self.ndim = ndim
        self.conv0 = conv(ndim, num_classes, ndf, 4, **kw)
        self.conv1 = conv(ndim, in_chans, ndf, 4, **kw)
        for i, mult in enumerate((2, 4, 8)):
            self.add_module(f"conv{i + 2}", conv(
                ndim, ndf * mult // 2 if i else ndf, ndf * mult, 4, **kw))
        self.classifier = dense(ndf * 8, 2, device, generator)
        self.dropout = Dropout(0.5)

    def forward(self, seg_map: torch.Tensor, image: torch.Tensor
                ) -> torch.Tensor:
        check_rank(seg_map, self.ndim, "FCDiscriminator")
        x = leaky_relu(self.conv0(channels_first(seg_map))
                       + self.conv1(channels_first(image)), 0.2)
        x = self.dropout(x)
        for i in range(2, 5):
            x = self.dropout(leaky_relu(getattr(self, f"conv{i}")(x), 0.2))
        return self.classifier(x.mean(dim=tuple(range(2, x.dim())))).float()


def fc_discriminator(**kw) -> FCDiscriminator:
    kw.setdefault("ndim", 2)
    return FCDiscriminator(**kw)


def fc3d_discriminator(**kw) -> FCDiscriminator:
    kw.setdefault("ndim", 3)
    return FCDiscriminator(**kw)


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(bias=False, device=device, generator=generator)
        out = 4 * features
        self.Conv_0 = conv(2, cin, features, 1, **kw)
        self.BatchNorm_0 = BatchNorm2d(features, device=device)
        self.Conv_1 = conv(2, features, features, 3, stride=stride,
                           padding=1, **kw)
        self.BatchNorm_1 = BatchNorm2d(features, device=device)
        self.Conv_2 = conv(2, features, out, 1, **kw)
        self.BatchNorm_2 = BatchNorm2d(out, device=device)
        self.project = cin != out or stride != 1
        if self.project:
            self.Conv_3 = conv(2, cin, out, 1, stride=stride, **kw)
            self.BatchNorm_3 = BatchNorm2d(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(h + x)


class ConvBlock2(nn.Module):
    """2 x [3x3 conv -> BatchNorm -> leaky ReLU 0.01]."""

    def __init__(self, cin: int, mid: int, out: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(padding=1, device=device, generator=generator)
        self.Conv_0 = conv(2, cin, mid, 3, **kw)
        self.BatchNorm_0 = BatchNorm2d(mid, device=device)
        self.Conv_1 = conv(2, mid, out, 3, **kw)
        self.BatchNorm_1 = BatchNorm2d(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.BatchNorm_0(self.Conv_0(x)), 0.01)
        return leaky_relu(self.BatchNorm_1(self.Conv_1(x)), 0.01)


class PreUNet(nn.Module):
    """ResNet-bottleneck encoder UNet."""

    def __init__(self, num_classes: int = 1, in_chans: int = 1,
                 depths: Sequence[int] = (2, 2, 2), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.depths = tuple(depths)
        self.stem = conv(2, in_chans, 64, 7, stride=2, padding=3, bias=False,
                         **kw)
        self.BatchNorm_0 = BatchNorm2d(64, device=device)
        cin = 64
        for i, (f, blocks) in enumerate(zip((64, 128, 256), depths)):
            for b in range(blocks):
                self.add_module(f"layer{i + 1}_{b}", Bottleneck(
                    cin, f, 2 if (b == 0 and i > 0) else 1, **kw))
                cin = 4 * f
        self.conv_up_1 = ConvBlock2(1024, 1024, 512, **kw)
        self.conv_up_2 = ConvBlock2(512 + 512, 512, 512, **kw)
        self.conv_up_3 = ConvBlock2(512, 512, 256, **kw)
        self.conv_up_4 = ConvBlock2(256 + 256, 256, 256, **kw)
        self.conv_up_5 = ConvBlock2(256, 256, 64, **kw)
        self.conv_up_6 = ConvBlock2(64, 64, 64, **kw)
        self.final = conv(2, 64, num_classes, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 2, "PreUNet")
        x = F.relu(self.BatchNorm_0(self.stem(channels_first(x))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        stages = []
        for i, blocks in enumerate(self.depths):
            for b in range(blocks):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
            stages.append(x)
        x1, x2, x3 = stages
        h = _up2(self.conv_up_1(x3))
        h = self.conv_up_2(torch.cat([h, x2], dim=1))
        h = _up2(self.conv_up_3(h))
        h = self.conv_up_4(torch.cat([h, x1], dim=1))
        h = _up2(_up2(self.conv_up_5(h)))
        return channels_last(self.final(self.conv_up_6(h))).float()


class MBConv(nn.Module):
    def __init__(self, cin: int, features: int, expand: int = 4,
                 stride: int = 1, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = cin * expand
        self.Conv_0 = conv(2, cin, mid, 1, bias=False, **kw)
        self.BatchNorm_0 = BatchNorm2d(mid, device=device)
        self.Conv_1 = conv(2, mid, mid, 3, stride=stride, padding=1,
                           groups=mid, bias=False, **kw)
        self.BatchNorm_1 = BatchNorm2d(mid, device=device)
        self.Conv_2 = conv(2, mid, max(mid // 16, 4), 1, **kw)
        self.Conv_3 = conv(2, max(mid // 16, 4), mid, 1, **kw)
        self.Conv_4 = conv(2, mid, features, 1, bias=False, **kw)
        self.BatchNorm_2 = BatchNorm2d(features, device=device)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.BatchNorm_0(self.Conv_0(x)))
        h = F.silu(self.BatchNorm_1(self.Conv_1(h)))
        s = F.silu(self.Conv_2(h.mean(dim=(2, 3), keepdim=True)))
        h = h * torch.sigmoid(self.Conv_3(s))
        h = self.BatchNorm_2(self.Conv_4(h))
        return h + x if self.residual else h


class EffiUNet(nn.Module):
    """EfficientNet (B3-like) encoder UNet."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 stage_features: Sequence[int] = (24, 32, 48, 96, 232),
                 stage_blocks: Sequence[int] = (2, 3, 3, 5, 2),
                 decoder_features: Sequence[int] = (256, 128, 64, 32), *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stage_blocks = tuple(stage_blocks)
        self.n_dec = len(decoder_features)
        self.stem = conv(2, in_chans, 32, 3, stride=2, padding=1, bias=False,
                         **kw)
        self.BatchNorm_0 = BatchNorm2d(32, device=device)
        cin, skips = 32, [32]
        for i, (f, blocks) in enumerate(zip(stage_features, stage_blocks)):
            for b in range(blocks):
                self.add_module(f"stage{i}_block{b}", MBConv(
                    cin, f, stride=2 if (b == 0 and i > 0) else 1, **kw))
                cin = f
            if i < len(stage_features) - 1:
                skips.append(f)
        for i, f in enumerate(decoder_features):
            self.add_module(f"dec{i}", ConvBlock2(cin + skips[-(i + 1)], f,
                                                  f, **kw))
            cin = f
        self.head = conv(2, cin, num_classes, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 2, "EffiUNet")
        x = F.silu(self.BatchNorm_0(self.stem(channels_first(x))))
        skips = [x]
        for i, blocks in enumerate(self.stage_blocks):
            for b in range(blocks):
                x = getattr(self, f"stage{i}_block{b}")(x)
            if i < len(self.stage_blocks) - 1:
                skips.append(x)
        for i in range(self.n_dec):
            x = torch.cat([_up2(x), skips[-(i + 1)]], dim=1)
            x = getattr(self, f"dec{i}")(x)
        return channels_last(self.head(_up2(x))).float()
