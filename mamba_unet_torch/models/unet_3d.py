"""The 3-D UNet, its deep-supervision variant and VoxResNet.

Port of ``mamba_unet_tpu/models/unet_3d.py`` (the reference's
``unet_3D.py``, ``unet_3D_dv_semi.py`` and ``VoxResNet.py``): filters
(64, 128, 256, 512, 1024) / ``feature_scale``, two 3^3 convs with flax's
BatchNorm and ReLU per block, 2^3 max-pool down, trilinear x2 up + concat
+ conv block, dropout 0.3 on the centre and before the 1^3 head; the
``dv_semi`` variant's 1^3 heads at every decoder scale, resized nearest to
the input (finest first); VoxResNet's SE-gated residual voxel blocks at
three scales whose heads are resized trilinearly and summed.

Volumes come in channels-last, (B, D, H, W, C), and logits go out as fp32
channels-last. The trilinear x2 (and x2^k) resizes are
``F.interpolate(align_corners=False)``, which equals ``jax.image.resize``
when upsampling by an integer factor; the nearest ones ``nearest-exact``.
Module names are the flax module's, so ``utils/convert.py`` maps them one
to one. Dropout draws from the generator the trainer hands every
``Drawing`` module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.segmamba import check_rank
from mamba_unet_torch.models.vnet import channels_first, channels_last, conv
from mamba_unet_torch.nn.layers import BatchNorm3d, Dropout


def resize(x: torch.Tensor, size: Sequence[int],
           mode: str = "trilinear") -> torch.Tensor:
    """``jax.image.resize`` of a channels-first volume (B, C, *spatial) to
    ``size`` (an integer upsampling: trilinear or nearest); the identity
    at the same size."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest-exact")
    return F.interpolate(x, size=tuple(size), mode=mode, align_corners=False)


def up3(x: torch.Tensor) -> torch.Tensor:
    return resize(x, [2 * s for s in x.shape[2:]])


class UnetConv3(nn.Module):
    """2 x [conv 3^3 -> BatchNorm -> ReLU]; channels-first."""

    def __init__(self, cin: int, features: int, use_bn: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.use_bn = use_bn
        self.conv1 = conv(3, cin, features, 3, padding=1, **kw)
        self.conv2 = conv(3, features, features, 3, padding=1, **kw)
        if use_bn:
            self.BatchNorm_0 = BatchNorm3d(features, device=device)
            self.BatchNorm_1 = BatchNorm3d(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate((self.conv1, self.conv2)):
            x = layer(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.relu(x)
        return x


class UnetUp3CT(nn.Module):
    """Trilinear x2 -> concat the skip (first) -> :class:`UnetConv3`."""

    def __init__(self, cin: int, skip: int, features: int,
                 use_bn: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = UnetConv3(cin + skip, features, use_bn, device=device,
                              generator=generator)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([skip, up3(x)], dim=1))


def _filters(feature_scale: int):
    return [int(v / feature_scale) for v in (64, 128, 256, 512, 1024)]


class _UNet3DBase(nn.Module):
    def __init__(self, in_chans: int, feature_scale: int, use_bn: bool,
                 device, generator):
        super().__init__()
        f = self.filters = _filters(feature_scale)
        kw = dict(device=device, generator=generator)
        cin = in_chans
        for i in range(4):
            self.add_module(f"conv{i + 1}", UnetConv3(cin, f[i], use_bn,
                                                      **kw))
            cin = f[i]
        self.center = UnetConv3(f[3], f[4], use_bn, **kw)
        for k in (3, 2, 1, 0):
            self.add_module(f"up_concat{k + 1}",
                            UnetUp3CT(f[k + 1], f[k], f[k], use_bn, **kw))
        self.dropout = Dropout(0.3)

    def encode(self, x: torch.Tensor):
        skips = []
        for i in range(4):
            x = getattr(self, f"conv{i + 1}")(x)
            skips.append(x)
            x = F.max_pool3d(x, 2)
        return skips, self.dropout(self.center(x))


class UNet3D(_UNet3DBase):
    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 feature_scale: int = 4, use_bn: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_chans, feature_scale, use_bn, device, generator)
        self.final = conv(3, self.filters[0], num_classes, 1, device=device,
                          generator=generator)
        self.dropout2 = Dropout(0.3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 3, "UNet3D")
        skips, x = self.encode(channels_first(x))
        for k in (3, 2, 1, 0):
            x = getattr(self, f"up_concat{k + 1}")(skips[k], x)
        x = self.final(self.dropout2(x))
        return channels_last(x).float()


class UNet3DDVSemi(_UNet3DBase):
    """1^3 heads at every decoder scale, resized nearest to the input;
    returns them finest first."""

    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 feature_scale: int = 4, use_bn: bool = True, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(in_chans, feature_scale, use_bn, device, generator)
        for k in (3, 2, 1, 0):
            self.add_module(f"dv_head{k + 1}", conv(
                3, self.filters[k], num_classes, 1, device=device,
                generator=generator))

    def forward(self, x: torch.Tensor):
        check_rank(x, 3, "UNet3DDVSemi")
        full = x.shape[1:4]
        skips, x = self.encode(channels_first(x))
        outs = []
        for k in (3, 2, 1, 0):
            x = getattr(self, f"up_concat{k + 1}")(skips[k], x)
            seg = getattr(self, f"dv_head{k + 1}")(x)
            outs.append(channels_last(resize(seg, full, "nearest")).float())
        return tuple(outs[::-1])


class SEBlock3D(nn.Module):
    def __init__(self, features: int, ratio: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Conv_0 = conv(3, features, features // ratio, 1, **kw)
        self.Conv_1 = conv(3, features // ratio, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(s))))
        return x * s


class VoxRex(nn.Module):
    def __init__(self, features: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.BatchNorm_0 = BatchNorm3d(features, device=device)
        self.Conv_0 = conv(3, features, features, 3, padding=1, bias=False,
                           **kw)
        self.BatchNorm_1 = BatchNorm3d(features, device=device)
        self.Conv_1 = conv(3, features, features, 3, padding=1, bias=False,
                           **kw)
        self.SEBlock3D_0 = SEBlock3D(features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        h = self.Conv_1(F.relu(self.BatchNorm_1(h)))
        return self.SEBlock3D_0(h) + x


class VoxResNet(nn.Module):
    """SE-residual voxel net, three scales, upsample-sum fusion."""

    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 feature_chns: int = 64, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feature_chns
        kw = dict(device=device, generator=generator)
        for i in range(3):
            self.add_module(f"Conv_{i}", conv(
                3, in_chans if i == 0 else f, f, 3, stride=1 if i == 0 else 2,
                padding=1, bias=False, **kw))
            self.add_module(f"BatchNorm_{i}", BatchNorm3d(f, device=device))
            self.add_module(f"VoxRex_{i}", VoxRex(f, **kw))
            self.add_module(f"head{i + 1}", conv(3, f, num_classes, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 3, "VoxResNet")
        full = x.shape[1:4]
        h, out = channels_first(x), 0
        for i in range(3):
            h = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Conv_{i}")(h)))
            h = getattr(self, f"VoxRex_{i}")(h)
            out = out + resize(getattr(self, f"head{i + 1}")(h), full)
        return channels_last(out).float()
