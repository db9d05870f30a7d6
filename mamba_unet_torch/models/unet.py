"""The 2-D UNet family: UNet, UNet_DS, UNet_URPC, UNet_CCT, TLUNet.

Port of ``mamba_unet_tpu/models/unet.py`` (the PyMIC UNet): feature widths
(16, 32, 64, 128, 256), encoder dropout (.05, .1, .2, .3, .5), conv pairs
of Conv3x3 -> BatchNorm -> LeakyReLU(0.01), 2x2 stride-2 transposed-conv
upsampling, a 3x3 output head. Images come in as (B, H, W, C) and logits
go out as fp32 (B, H, W, classes), as every model of the port; inside, the
layers run on (B, C, H, W). Module names follow the upstream torch
checkpoints (``encoder.in_conv.conv_conv.{0,1,4,5}``,
``encoder.down1.maxpool_conv.1.*``, ``decoder.up1.up``, ``decoder.up1.conv``,
``decoder.out_conv``).

BatchNorm is flax's (``nn.layers.BatchNorm2d``). Dropout and the aux
decoders' feature perturbations draw, in training, from the generator the
trainer hands every :class:`~mamba_unet_torch.nn.layers.Drawing` module.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import (
    BatchNorm2d,
    Drawing,
    Dropout,
    dropout,
    lecun_normal_,
    trunc_normal_,
)

FT_CHNS = (16, 32, 64, 128, 256)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def conv3x3(cin: int, cout: int, device, generator) -> nn.Conv2d:
    """flax ``nn.Conv(cout, (3, 3), padding=1)``: lecun-normal, zero bias."""
    conv = nn.Conv2d(cin, cout, 3, padding=1, device=device)
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


class ConvBlock(nn.Module):
    """[Conv3x3 -> BN -> LeakyReLU -> Dropout -> Conv3x3 -> BN -> LeakyReLU]."""

    def __init__(self, cin: int, cout: int, dropout_p: float = 0.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_conv = nn.Sequential(
            conv3x3(cin, cout, device, generator),
            BatchNorm2d(cout, device=device),
            nn.LeakyReLU(0.01),
            Dropout(dropout_p),
            conv3x3(cout, cout, device, generator),
            BatchNorm2d(cout, device=device),
            nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_conv(x)


class DownBlock(nn.Module):
    """2x2 max pool -> ConvBlock."""

    def __init__(self, cin: int, cout: int, dropout_p: float, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2),
            ConvBlock(cin, cout, dropout_p, device=device,
                      generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Encoder(nn.Module):
    def __init__(self, in_chans: int = 1, ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.in_conv = ConvBlock(in_chans, ft_chns[0], dropout[0], **kw)
        self.down1 = DownBlock(ft_chns[0], ft_chns[1], dropout[1], **kw)
        self.down2 = DownBlock(ft_chns[1], ft_chns[2], dropout[2], **kw)
        self.down3 = DownBlock(ft_chns[2], ft_chns[3], dropout[3], **kw)
        self.down4 = DownBlock(ft_chns[3], ft_chns[4], dropout[4], **kw)

    def forward(self, x: torch.Tensor):
        feats = [self.in_conv(x)]
        for down in (self.down1, self.down2, self.down3, self.down4):
            feats.append(down(feats[-1]))
        return feats


class UpBlock(nn.Module):
    """ConvTranspose 2x2 stride 2 -> concat [skip, up] -> ConvBlock.

    flax's ``nn.ConvTranspose`` applies its kernel unflipped, torch's
    ``ConvTranspose2d`` flipped: a flax kernel (kh, kw, in, out) is this
    weight (in, out, kh, kw) flipped in both spatial axes
    (``utils/convert.py``)."""

    def __init__(self, cin: int, skip: int, cout: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, skip, 2, stride=2, device=device)
        # flax's lecun-normal: fan-in = in x kh x kw of the (kh, kw, in, out)
        # kernel
        trunc_normal_(self.up.weight,
                      math.sqrt(1.0 / (cin * 4)) / 0.87962566103423978,
                      generator)
        nn.init.zeros_(self.up.bias)
        self.conv = ConvBlock(2 * skip, cout, 0.0, device=device,
                              generator=generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([skip, self.up(x)], dim=1))


def _feature_dropout(x: torch.Tensor, generator: torch.Generator
                     ) -> torch.Tensor:
    """Attention-thresholded channel dropout: zero the pixels whose channel
    mean reaches a threshold drawn in [0.7, 0.9) of the sample's maximum
    (one draw for the batch)."""
    attn = x.mean(dim=1, keepdim=True)  # (B, 1, H, W)
    mx = attn.flatten(1).amax(1).view(-1, 1, 1, 1)
    frac = 0.7 + 0.2 * torch.rand((), device=x.device, generator=generator)
    return x * (attn < mx * frac).to(x.dtype)


def _feature_noise(x: torch.Tensor, generator: torch.Generator,
                   uniform_range: float = 0.3) -> torch.Tensor:
    """Multiplicative uniform noise in [-range, range), one draw shared by
    the batch."""
    noise = torch.rand(x.shape[1:], device=x.device, generator=generator)
    noise = (2.0 * noise - 1.0) * uniform_range
    return x * noise.to(x.dtype) + x


class Perturbation(Drawing):
    """One of the aux heads' feature perturbations in training
    (``dropout``: p; ``feature_dropout``; ``feature_noise``), the identity
    in eval mode."""

    def __init__(self, kind: str, p: float = 0.3):
        super().__init__()
        if kind not in ("dropout", "feature_dropout", "feature_noise"):
            raise ValueError(f"unknown perturbation {kind!r}")
        self.kind, self.p = kind, p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        gen = self._generator()
        if self.kind == "dropout":
            return dropout(x, self.p, gen)
        if self.kind == "feature_dropout":
            return _feature_dropout(x, gen)
        return _feature_noise(x, gen)


class Decoder(nn.Module):
    def __init__(self, num_classes: int, ft_chns: Sequence[int] = FT_CHNS, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        f = ft_chns
        kw = dict(device=device, generator=generator)
        self.up1 = UpBlock(f[4], f[3], f[3], **kw)
        self.up2 = UpBlock(f[3], f[2], f[2], **kw)
        self.up3 = UpBlock(f[2], f[1], f[1], **kw)
        self.up4 = UpBlock(f[1], f[0], f[0], **kw)
        self.out_conv = conv3x3(f[0], num_classes, device, generator)

    def forward(self, feats) -> torch.Tensor:
        x = feats[4]
        for up, k in zip((self.up1, self.up2, self.up3, self.up4),
                         (3, 2, 1, 0)):
            x = up(x, feats[k])
        return self.out_conv(x)


class DecoderDS(Decoder):
    """Deep-supervision decoder: a 3x3 aux head after each of the first
    three up stages (``out_conv_dp3``, ``dp2``, ``dp1``), nearest-resized to
    the input's size. ``mode="urpc"`` perturbs the aux heads' features in
    training: Dropout(0.5) after up1, FeatureDropout after up2,
    FeatureNoise after up3. Returns (main, dp1, dp2, dp3)."""

    def __init__(self, num_classes: int, mode: str = "ds",
                 ft_chns: Sequence[int] = FT_CHNS, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_classes, ft_chns, device=device,
                         generator=generator)
        if mode not in ("ds", "urpc"):
            raise ValueError(f"unknown DecoderDS mode {mode!r}")
        f = ft_chns
        self.out_conv_dp3 = conv3x3(f[3], num_classes, device, generator)
        self.out_conv_dp2 = conv3x3(f[2], num_classes, device, generator)
        self.out_conv_dp1 = conv3x3(f[1], num_classes, device, generator)
        self.perturbs = nn.ModuleList(
            [Perturbation("dropout", 0.5), Perturbation("feature_dropout"),
             Perturbation("feature_noise")] if mode == "urpc" else [])

    def forward(self, feats):
        out_shape = feats[0].shape[2:]
        x, outs = feats[4], []
        heads = (self.out_conv_dp3, self.out_conv_dp2, self.out_conv_dp1)
        for i, (up, k) in enumerate(zip((self.up1, self.up2, self.up3,
                                         self.up4), (3, 2, 1, 0))):
            x = up(x, feats[k])
            if k > 0:
                h = self.perturbs[i](x) if self.perturbs else x
                outs.append(F.interpolate(heads[i](h), size=out_shape,
                                          mode="nearest-exact"))
        return (self.out_conv(x), *outs[::-1])


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).float()


class UNet(nn.Module):
    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoder = Encoder(in_chans, ft_chns, dropout, **kw)
        self.decoder = Decoder(num_classes, ft_chns, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _to_nhwc(self.decoder(self.encoder(_to_nchw(x))))


class UNetDS(nn.Module):
    """UNet with deep supervision: (main, dp1, dp2, dp3), all full size."""

    mode = "ds"

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoder = Encoder(in_chans, ft_chns, dropout, **kw)
        self.decoder = DecoderDS(num_classes, self.mode, ft_chns, **kw)

    def forward(self, x: torch.Tensor):
        return tuple(_to_nhwc(o)
                     for o in self.decoder(self.encoder(_to_nchw(x))))


class UNetURPC(UNetDS):
    """UNet_DS with the URPC aux-feature perturbations in training."""

    mode = "urpc"


class UNetCCT(nn.Module):
    """Main decoder + 3 aux decoders on perturbed encoder features
    (FeatureNoise, Dropout(0.3), FeatureDropout): (main, aux1, aux2,
    aux3)."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoder = Encoder(in_chans, ft_chns, dropout, **kw)
        self.main_decoder = Decoder(num_classes, ft_chns, **kw)
        self.aux_decoder1 = Decoder(num_classes, ft_chns, **kw)
        self.aux_decoder2 = Decoder(num_classes, ft_chns, **kw)
        self.aux_decoder3 = Decoder(num_classes, ft_chns, **kw)
        self.perturbs = nn.ModuleList([
            Perturbation("feature_noise"), Perturbation("dropout", 0.3),
            Perturbation("feature_dropout")])

    def forward(self, x: torch.Tensor):
        feats = self.encoder(_to_nchw(x))
        outs = [self.main_decoder(feats)]
        for dec, perturb in zip((self.aux_decoder1, self.aux_decoder2,
                                 self.aux_decoder3), self.perturbs):
            outs.append(dec([perturb(f) for f in feats]))
        return tuple(_to_nhwc(o) for o in outs)


class TLUNet(nn.Module):
    """Two stacked UNets: the second segments the softmax of the first."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 ft_chns: Sequence[int] = FT_CHNS,
                 dropout: Sequence[float] = DROPOUT, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.encoder = Encoder(in_chans, ft_chns, dropout, **kw)
        self.decoder = Decoder(num_classes, ft_chns, **kw)
        self.mask_encoder = Encoder(num_classes, ft_chns, dropout, **kw)
        self.mask_decoder = Decoder(num_classes, ft_chns, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seg = self.decoder(self.encoder(_to_nchw(x)))
        soft = torch.softmax(seg, dim=1)
        return _to_nhwc(self.mask_decoder(self.mask_encoder(soft)))
