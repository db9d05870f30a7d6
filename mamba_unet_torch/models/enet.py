"""ENet: a real-time segmentation net of bottlenecks with dilated and
asymmetric convolutions.

Port of ``mamba_unet_tpu/models/enet.py`` (the reference's ``enet.py``):
an initial block (3x3/2 conv beside a 2x2 max pool), two downsampling
stages whose max-pool positions the matching upsampling stages unpool
into, the dilation ladder 2/4/8/16 and 5x5 asymmetric (5x1 + 1x5)
bottlenecks, PReLU in the encoder and ReLU in the decoder, and a 3x3/2
transposed-conv head cropped to the input size.

Unpooling follows the JAX module: each 2x2 window's first maximum (in
row-major order) takes the value, as a one-hot over the window, not
``max_pool2d``'s indices: the two differ where a window ties, which is
common after ReLU zeros. Images come in channels-last, (B, H, W, C), and
logits go out as fp32 channels-last. Module names are the flax module's
(``InitialBlock_0``, ``DownsamplingBottleneck_{i}``,
``RegularBottleneck_{i}``, ``UpsamplingBottleneck_{i}``,
``ConvTranspose_0``; inside them ``Conv_{i}``, ``BatchNorm_{i}``,
``PReLU_{i}``); dropout draws from the generator the trainer hands every
``Drawing`` module.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.vnet import (
    channels_first,
    channels_last,
    conv,
    conv_transpose,
)
from mamba_unet_torch.nn.layers import BatchNorm2d, Dropout


class PReLU(nn.Module):
    """flax-style PReLU: a learnable per-channel slope ``alpha`` (0.25)
    below 0; channels-first."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.reshape(1, -1, *([1] * (x.dim() - 2)))
        return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def maxpool_with_argmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2/2 max pool of (B, C, H, W) and the one-hot (B, C, H/2, W/2, 4) of
    each window's first maximum."""
    b, c, H, W = x.shape
    w = x.reshape(b, c, H // 2, 2, W // 2, 2).permute(0, 1, 2, 4, 3, 5)
    w = w.reshape(b, c, H // 2, W // 2, 4)
    pooled = w.amax(-1)
    onehot = (w == pooled[..., None]).to(x.dtype)
    onehot = onehot * (onehot.cumsum(-1) == 1)
    return pooled, onehot


def max_unpool(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`maxpool_with_argmax`: each value to its window's
    position of the maximum."""
    b, c, h, w = x.shape
    out = (x[..., None] * onehot).reshape(b, c, h, w, 2, 2)
    return out.permute(0, 1, 2, 4, 3, 5).reshape(b, c, 2 * h, 2 * w)


class _Compact(nn.Module):
    """Registers layers under flax's auto names (``Conv_0``, ...); the
    blocks keep them in plain lists, which register nothing again."""

    def __init__(self, relu: bool, device, generator):
        super().__init__()
        self.relu, self._kw = relu, dict(device=device, generator=generator)
        self._count = {}

    def _add(self, kind: str, module: nn.Module) -> nn.Module:
        i = self._count.get(kind, 0)
        self._count[kind] = i + 1
        self.add_module(f"{kind}_{i}", module)
        return module

    def _conv(self, cin, cout, kernel, **kw) -> nn.Module:
        return self._add("Conv", conv(2, cin, cout, kernel, bias=False, **kw,
                                      **self._kw))

    def _bn(self, c) -> nn.Module:
        return self._add("BatchNorm", BatchNorm2d(c,
                                                  device=self._kw["device"]))

    def _act(self, c) -> nn.Module:
        if self.relu:
            return nn.ReLU()
        return self._add("PReLU", PReLU(c, device=self._kw["device"]))


class InitialBlock(_Compact):
    def __init__(self, cin: int, features: int = 16, relu: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(relu, device, generator)
        self.layers = [self._conv(cin, features - cin, 3, stride=2,
                                  padding=1),
                       self._bn(features), self._act(features)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_, bn, act = self.layers
        return act(bn(torch.cat([conv_(x), F.max_pool2d(x, 2)], dim=1)))


class RegularBottleneck(_Compact):
    def __init__(self, channels: int, internal_ratio: int = 4,
                 kernel_size: int = 3, padding: int = 1, dilation: int = 1,
                 asymmetric: bool = False, dropout_prob: float = 0.0,
                 relu: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(relu, device, generator)
        inter = channels // internal_ratio
        k, p = kernel_size, padding
        layers: List[nn.Module] = [self._conv(channels, inter, 1),
                                   self._bn(inter), self._act(inter)]
        if asymmetric:
            layers += [self._conv(inter, inter, (k, 1), padding=(p, 0)),
                       self._bn(inter), self._act(inter),
                       self._conv(inter, inter, (1, k), padding=(0, p))]
        else:
            layers.append(self._conv(inter, inter, k, padding=p,
                                     dilation=dilation))
        layers += [self._bn(inter), self._act(inter),
                   self._conv(inter, channels, 1), self._bn(channels)]
        self.ext = layers
        self.dropout = Dropout(dropout_prob)
        self.out_act = [self._act(channels)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.ext:
            h = layer(h)
        return self.out_act[0](x + self.dropout(h))


class DownsamplingBottleneck(_Compact):
    def __init__(self, cin: int, out_channels: int, internal_ratio: int = 4,
                 dropout_prob: float = 0.0, relu: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(relu, device, generator)
        inter = out_channels // internal_ratio
        self.pad = out_channels - cin
        self.ext = [self._conv(cin, inter, 2, stride=2), self._bn(inter),
                    self._act(inter), self._conv(inter, inter, 3, padding=1),
                    self._bn(inter), self._act(inter),
                    self._conv(inter, out_channels, 1),
                    self._bn(out_channels)]
        self.dropout = Dropout(dropout_prob)
        self.out_act = [self._act(out_channels)]

    def forward(self, x: torch.Tensor):
        main, onehot = maxpool_with_argmax(x)
        main = F.pad(main, (0, 0, 0, 0, 0, self.pad))
        h = x
        for layer in self.ext:
            h = layer(h)
        return self.out_act[0](main + self.dropout(h)), onehot


class UpsamplingBottleneck(_Compact):
    def __init__(self, cin: int, out_channels: int, internal_ratio: int = 4,
                 dropout_prob: float = 0.0, relu: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(relu, device, generator)
        inter = out_channels // internal_ratio
        self.main = [self._conv(cin, out_channels, 1),
                     self._bn(out_channels)]
        self.ext = [self._conv(cin, inter, 1), self._bn(inter),
                    self._act(inter),
                    self._add("ConvTranspose", conv_transpose(
                        2, inter, inter, 2, bias=False, **self._kw)),
                    self._bn(inter), self._act(inter),
                    self._conv(inter, out_channels, 1),
                    self._bn(out_channels)]
        self.dropout = Dropout(dropout_prob)
        self.out_act = [self._act(out_channels)]

    def forward(self, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        main = max_unpool(self.main[1](self.main[0](x)), onehot)
        h = x
        for layer in self.ext:
            h = layer(h)
        return self.out_act[0](main + self.dropout(h))


class ENet(nn.Module):
    def __init__(self, num_classes: int = 4, in_chans: int = 1, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        enc = dict(relu=False, **kw)
        dec = dict(relu=True, **kw)
        self.InitialBlock_0 = InitialBlock(in_chans, 16, **kw)
        down = [DownsamplingBottleneck(16, 64, dropout_prob=0.01, **enc)]
        regular = [RegularBottleneck(64, padding=1, dropout_prob=0.01, **enc)
                   for _ in range(4)]
        down.append(DownsamplingBottleneck(64, 128, dropout_prob=0.1, **enc))
        for _ in range(2):  # stages 2 and 3 share the ladder
            for extra in (dict(padding=1), dict(dilation=2, padding=2),
                          dict(kernel_size=5, padding=2, asymmetric=True),
                          dict(dilation=4, padding=4), dict(padding=1),
                          dict(dilation=8, padding=8),
                          dict(kernel_size=5, padding=2, asymmetric=True),
                          dict(dilation=16, padding=16)):
                regular.append(RegularBottleneck(128, dropout_prob=0.1,
                                                 **extra, **enc))
        up = [UpsamplingBottleneck(128, 64, dropout_prob=0.1, **dec),
              UpsamplingBottleneck(64, 16, dropout_prob=0.1, **dec)]
        regular += [RegularBottleneck(64, padding=1, dropout_prob=0.1, **dec)
                    for _ in range(2)]
        regular.append(RegularBottleneck(16, padding=1, dropout_prob=0.1,
                                         **dec))
        for name, blocks in (("DownsamplingBottleneck", down),
                             ("RegularBottleneck", regular),
                             ("UpsamplingBottleneck", up)):
            for i, block in enumerate(blocks):
                self.add_module(f"{name}_{i}", block)
        # kernel 3 over stride 2: torch's output is one longer than flax's
        # SAME one, which the crop to the input size removes
        self.ConvTranspose_0 = conv_transpose(2, 16, num_classes, 2, 3,
                                              bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = self.InitialBlock_0(channels_first(x))
        x, oh1 = self.DownsamplingBottleneck_0(x)
        for i in range(4):
            x = getattr(self, f"RegularBottleneck_{i}")(x)
        x, oh2 = self.DownsamplingBottleneck_1(x)
        for i in range(4, 20):
            x = getattr(self, f"RegularBottleneck_{i}")(x)
        x = self.UpsamplingBottleneck_0(x, oh2)
        x = self.RegularBottleneck_20(x)
        x = self.RegularBottleneck_21(x)
        x = self.UpsamplingBottleneck_1(x, oh1)
        x = self.RegularBottleneck_22(x)
        x = self.ConvTranspose_0(x)[:, :, :h, :w]
        return channels_last(x).float()
