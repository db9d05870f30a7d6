"""Small zoo members: the contrastive projector, the classifier and jigsaw
heads, and PNet2D.

Port of ``mamba_unet_tpu/models/small_nets.py``: ``Projectors`` (conv/pool
x2 -> 2 * ndf channels at a quarter of the size; the contrastive-
consistency trainer's patch-NCE heads), ``Classifier`` (conv/pool x3 ->
1x1), ``JigsawClassifier`` (grid-shuffle position logits) and ``PNet2D``
(DeepIGeoS P-Net: 5 dilated conv blocks, concat -> 1x1 fuse -> dropout
head). Inputs and outputs are channels-last, as everywhere in the port;
inside, the layers run on (B, C, H, W). Convolutions are flax's
(lecun-normal weights, zero bias), BatchNorm is flax's
(``nn.layers.BatchNorm2d``). The names follow the flax modules, so that
``utils.convert.params_from_jax`` maps them: a ``_ConvBNRelu_i`` is
``blocks.i.conv_conv.{0,1}``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.unet import conv3x3
from mamba_unet_torch.nn.layers import BatchNorm2d, Dropout, lecun_normal_


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv1x1(cin: int, cout: int, device, generator) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (1, 1))``: lecun-normal, zero bias."""
    conv = nn.Conv2d(cin, cout, 1, device=device)
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


class ConvBNRelu(nn.Module):
    """Conv3x3 -> BatchNorm -> ReLU on (B, C, H, W)."""

    def __init__(self, cin: int, cout: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_conv = nn.Sequential(conv3x3(cin, cout, device, generator),
                                       BatchNorm2d(cout, device=device),
                                       nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_conv(x)


class Projectors(nn.Module):
    """Contrastive projector head: [ConvBNRelu -> 2x2 max pool] x 2,
    (B, H, W, input_nc) -> (B, H/4, W/4, 2 * ndf)."""

    def __init__(self, input_nc: int = 4, ndf: int = 8, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.blocks = nn.ModuleList([ConvBNRelu(input_nc, ndf, **kw),
                                     ConvBNRelu(ndf, 2 * ndf, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for block in self.blocks:
            x = F.max_pool2d(block(x), 2)
        return _nhwc(x)


class Classifier(nn.Module):
    """[ConvBNRelu -> 2x2 max pool] x 3 (ndf, 2 ndf, 4 ndf) -> 1x1 conv."""

    def __init__(self, inp_dim: int = 4, ndf: int = 8, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        widths = (inp_dim, ndf, 2 * ndf, 4 * ndf)
        self.blocks = nn.ModuleList(ConvBNRelu(a, b, **kw)
                                    for a, b in zip(widths, widths[1:]))
        self.final = conv1x1(4 * ndf, 4 * ndf, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        for block in self.blocks:
            x = F.max_pool2d(block(x), 2)
        return _nhwc(self.final(x))


class JigsawClassifier(nn.Module):
    """Grid-shuffle position logits: ConvBNRelu (ndf²) -> 7x7 max pool ->
    ConvBNRelu (2 ndf²) -> 8x8 max pool -> ConvBNRelu (2 ndf), returned as
    (B, 2 ndf, h * w)."""

    def __init__(self, inp_dim: int = 4, ndf: int = 8,
                 grid_shape: Tuple[int, int] = (4, 4), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.grid_shape = tuple(grid_shape)
        widths = (inp_dim, ndf * ndf, 2 * ndf * ndf, 2 * ndf)
        self.blocks = nn.ModuleList(ConvBNRelu(a, b, **kw)
                                    for a, b in zip(widths, widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.blocks[0](_nchw(x)), 7)
        x = F.max_pool2d(self.blocks[1](x), 8)
        return self.blocks[2](x).flatten(2)


class PNetBlock(nn.Module):
    """Two [dilated Conv3x3 -> BatchNorm -> LeakyReLU(0.01)]."""

    def __init__(self, cin: int, features: int, dilation: int, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        convs = []
        for c in (cin, features):
            conv = nn.Conv2d(c, features, 3, padding=dilation,
                             dilation=dilation, device=device)
            lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
        self.conv1, self.conv2 = convs
        self.bn1 = BatchNorm2d(features, device=device)
        self.bn2 = BatchNorm2d(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        return F.leaky_relu(self.bn2(self.conv2(x)), 0.01)


class PNet2D(nn.Module):
    """P-Net: 5 dilated blocks (dilations ``ratios``), their outputs
    concatenated -> two 1x1 fuse convs -> dropout(0.3) -> 1x1 -> dropout ->
    1x1 to the classes."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 num_filters: int = 64,
                 ratios: Sequence[int] = (1, 2, 4, 8, 16), *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nf = num_filters
        for i, r in enumerate(ratios):
            setattr(self, f"block{i + 1}",
                    PNetBlock(in_chans if i == 0 else nf, nf, r,
                              device=device, generator=generator))
        self.n_blocks = len(ratios)
        cat = nf * len(ratios)
        self.cat_conv1 = conv1x1(cat, cat, device, generator)
        self.cat_conv2 = conv1x1(cat, 2 * nf, device, generator)
        self.out_conv1 = conv1x1(2 * nf, nf, device, generator)
        self.out_conv2 = conv1x1(nf, num_classes, device, generator)
        self.dropout1 = Dropout(0.3)
        self.dropout2 = Dropout(0.3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _nchw(x)
        feats = []
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i + 1}")(h)
            feats.append(h)
        h = F.leaky_relu(self.cat_conv1(torch.cat(feats, 1)), 0.01)
        h = F.leaky_relu(self.cat_conv2(h), 0.01)
        h = F.leaky_relu(self.out_conv1(self.dropout1(h)), 0.01)
        h = self.out_conv2(self.dropout2(h))
        return _nhwc(h).float()
