"""The VNet family (2-D and 3-D) and MagicNet's VNet with its cube-location
classifier.

Port of ``mamba_unet_tpu/models/vnet.py`` (the reference's ``vnet.py``,
``magicnet.py`` and ``magicnet_2D.py``), rank-generic over ``ndim`` 2 or
3: five encoder blocks of 1/2/3/3/3 convs (3^ndim, padding 1, each with
its norm and a ReLU) with stride-2 conv downsampling between them, an
additive-skip decoder with stride-2 transposed-conv upsampling, and a 1^ndim
head on the ``n_filters``-channel embedding. Images come in channels-last,
(B, *spatial, C), and logits go out as fp32 channels-last, as every model
of the port; inside, the layers run on (B, C, *spatial) for cuDNN.
``VNetMagic`` also takes and returns channels-last feature lists, so its
cube-location head flattens a bottleneck in the JAX model's (spatial,
channel) order.

Registry names (``models/registry.py``): ``vnet`` (2-D, instance norm),
``vnet_3D`` (3-D, batch norm, dropout 0.5 on the bottleneck and the
embedding), ``magicnet`` (3-D ``VNetMagic``) and ``magicnet_2D``.

Norms: ``instancenorm`` and ``groupnorm`` are flax's ``GroupNorm`` (group
size 1, or 16 groups; :class:`~mamba_unet_torch.nn.layers.GroupNorm`),
``batchnorm`` flax's ``BatchNorm``. Dropout draws from the generator the
trainer hands every ``Drawing`` module. Module names follow the upstream
torch checkpoints: ``encoder.block_one.conv.{0,1}`` (conv, norm; a
stage's ReLU takes the index after its norm), ``encoder.block_one_dw.conv``,
``decoder.block_five_up.conv`` (the transposed conv, norm),
``decoder.out_conv``, ``fc_layer.{fc1,bn,fc2}``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from mamba_unet_torch.nn.layers import (
    BatchNorm1d,
    BatchNorm2d,
    BatchNorm3d,
    Dropout,
    GroupNorm,
    at_least_fp32,
    lecun_normal_,
    leaky_relu,
    trunc_normal_,
)

NORMALIZATIONS = ("batchnorm", "groupnorm", "instancenorm", "none")


def dense(in_features: int, out_features: int, device,
          generator: Optional[torch.Generator]) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal weight, zero bias."""
    layer = nn.Linear(in_features, out_features, device=device)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def conv(ndim: int, cin: int, cout: int, kernel, stride=1, padding=0, *,
         dilation=1, groups: int = 1, bias: bool = True, device=None,
         generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax ``nn.Conv`` of rank ``ndim``: lecun-normal, zero bias (kernel,
    stride, padding and dilation an int or one per axis)."""
    cls = nn.Conv3d if ndim == 3 else nn.Conv2d
    layer = cls(cin, cout, kernel, stride=stride, padding=padding,
                dilation=dilation, groups=groups, bias=bias, device=device)
    lecun_normal_(layer.weight, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def conv_transpose(ndim: int, cin: int, cout: int, stride, kernel=None, *,
                   bias: bool = True, device=None,
                   generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
    """flax ``nn.ConvTranspose(cout, kernel, strides=stride)`` (kernel
    default the stride; an int or one per axis): lecun-normal with flax's
    fan-in (in x prod(kernel) of its (k..., in, out) kernel), zero bias.
    flax applies the kernel unflipped and torch flipped
    (``utils/convert.py`` flips it). Where the kernel exceeds the stride,
    torch's output is longer than flax's ``SAME`` one, which is its first
    stride x input elements per axis: the caller crops."""
    cls = nn.ConvTranspose3d if ndim == 3 else nn.ConvTranspose2d
    kernel = stride if kernel is None else kernel
    layer = cls(cin, cout, kernel, stride=stride, bias=bias, device=device)
    fan_in = cin * layer.weight[0, 0].numel()
    trunc_normal_(layer.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                  generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def norm_layer(kind: str, channels: int, ndim: int, device
               ) -> Optional[nn.Module]:
    if kind == "batchnorm":
        return (BatchNorm3d if ndim == 3 else BatchNorm2d)(channels,
                                                           device=device)
    if kind == "groupnorm":
        return GroupNorm(channels, num_groups=16, device=device)
    if kind == "instancenorm":
        return GroupNorm(channels, group_size=1, device=device)
    if kind == "none":
        return None
    raise ValueError(f"normalization must be one of {NORMALIZATIONS}, got "
                     f"{kind!r}")


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class ConvStack(nn.Module):
    """``n_stages`` x [Conv 3^ndim -> norm -> ReLU]. (The JAX module's
    residual variant, which no registry name builds, is not ported.)"""

    def __init__(self, n_stages: int, cin: int, cout: int, ndim: int = 3,
                 normalization: str = "none", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ops: List[nn.Module] = []
        for i in range(n_stages):
            ops.append(conv(ndim, cin if i == 0 else cout, cout, 3,
                            padding=1, device=device, generator=generator))
            norm = norm_layer(normalization, cout, ndim, device)
            if norm is not None:
                ops.append(norm)
            ops.append(nn.ReLU())
        self.conv = nn.Sequential(*ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Resample(nn.Module):
    """Down (a stride-2 conv) or up (a stride-2 transposed conv) sampling,
    then norm and ReLU."""

    def __init__(self, cin: int, cout: int, ndim: int = 3, up: bool = False,
                 normalization: str = "none", stride: int = 2, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        first = (conv_transpose(ndim, cin, cout, stride, device=device,
                                generator=generator) if up
                 else conv(ndim, cin, cout, stride, stride=stride,
                           device=device, generator=generator))
        norm = norm_layer(normalization, cout, ndim, device)
        self.conv = nn.Sequential(
            first, *([norm] if norm is not None else []), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


# (name, convs, width multiple) of the encoder blocks and of the decoder's
# blocks after each upsampling
_ENCODER = (("one", 1, 1), ("two", 2, 2), ("three", 3, 4), ("four", 3, 8),
            ("five", 3, 16))
_DECODER = (("five", "six", 3, 8), ("six", "seven", 3, 4),
            ("seven", "eight", 2, 2), ("eight", "nine", 1, 1))


class VNetEncoder(nn.Module):
    """(B, C, *spatial) -> [x1 .. x5], each block's output, channels-first
    (x5 after the dropout when ``has_dropout``)."""

    def __init__(self, in_chans: int = 1, n_filters: int = 16, ndim: int = 3,
                 normalization: str = "none", has_dropout: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        cin = in_chans
        for i, (name, n, mult) in enumerate(_ENCODER):
            width = mult * n_filters
            setattr(self, f"block_{name}", ConvStack(
                n, cin, width, ndim, normalization, **kw))
            if i < len(_ENCODER) - 1:
                setattr(self, f"block_{name}_dw", Resample(
                    width, 2 * width, ndim, False, normalization, **kw))
            cin = 2 * width
        self.dropout = Dropout(0.5 if has_dropout else 0.0)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, (name, _, _) in enumerate(_ENCODER):
            x = getattr(self, f"block_{name}")(x)
            feats.append(x)
            if i < len(_ENCODER) - 1:
                x = getattr(self, f"block_{name}_dw")(x)
        feats[-1] = self.dropout(feats[-1])
        return feats


class VNetDecoder(nn.Module):
    """[x1 .. x5] channels-first -> (fp32 logits, the ``n_filters``-channel
    embedding), channels-first."""

    def __init__(self, num_classes: int = 2, n_filters: int = 16,
                 ndim: int = 3, normalization: str = "none",
                 has_dropout: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        for up, block, n, mult in _DECODER:
            width = mult * n_filters
            setattr(self, f"block_{up}_up", Resample(
                2 * width, width, ndim, True, normalization, **kw))
            setattr(self, f"block_{block}", ConvStack(
                n, width, width, ndim, normalization, **kw))
        self.out_conv = conv(ndim, n_filters, num_classes, 1, **kw)
        self.dropout = Dropout(0.5 if has_dropout else 0.0)

    def head(self, embedding: torch.Tensor) -> torch.Tensor:
        """The 1^ndim prediction conv, fp32 logits, channels-first."""
        return at_least_fp32(self.out_conv(embedding))

    def forward(self, feats: Sequence[torch.Tensor]):
        x = feats[-1]
        for i, (up, block, _, _) in enumerate(_DECODER):
            x = getattr(self, f"block_{up}_up")(x) + feats[-2 - i]
            x = getattr(self, f"block_{block}")(x)
        embedding = self.dropout(x)
        return self.head(embedding), embedding


class FcLayer(nn.Module):
    """Cube-location classifier: one cube's flattened bottleneck
    (``in_features``, which flax infers from its input) -> Dense(4096) ->
    BatchNorm -> LeakyReLU(0.2) -> Dense((patch_size // cube_size)**ndim)
    location logits, fp32."""

    def __init__(self, in_features: int, cube_size: int = 32,
                 patch_size: int = 96, ndim: int = 3, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        nt = patch_size // cube_size
        self.fc1 = dense(in_features, 4096, device, generator)
        self.bn = BatchNorm1d(4096, device=device)
        self.fc2 = dense(4096, nt ** ndim, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.bn(self.fc1(x)), 0.2)
        return at_least_fp32(self.fc2(x))


class VNet(nn.Module):
    """The plain VNet: (B, *spatial, C) -> fp32 logits (B, *spatial,
    classes)."""

    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 n_filters: int = 16, ndim: int = 3,
                 normalization: str = "batchnorm", has_dropout: bool = False,
                 *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(n_filters=n_filters, ndim=ndim,
                  normalization=normalization, has_dropout=has_dropout,
                  device=device, generator=generator)
        self.encoder = VNetEncoder(in_chans, **kw)
        self.decoder = VNetDecoder(num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seg, _ = self.decoder(self.encoder(channels_first(x)))
        return channels_last(seg)


class VNetMagic(nn.Module):
    """VNet_Magic: the VNet with the cube-location head, its encoder and
    decoder callable apart for the MagicNet cube pipeline. Every tensor in
    and out is channels-last:

      forward(x)                 -> (seg logits fp32, embedding)
      forward_encoder(x)         -> [x1 .. x5]
      forward_decoder(feats)     -> (seg logits fp32, embedding)
      forward_location(flat)     -> cube-location logits
      forward_prediction_head(e) -> seg logits fp32

    The location head takes one cube's flattened bottleneck, 16 x
    ``n_filters`` x (``cube_size`` / 16)^ndim features (2,048 for the
    reference's 32³ cubes and 16 filters), and gives
    (``patch_size`` // ``cube_size``)^ndim location logits. The head exists
    from construction (the JAX model creates it through ``init_all``)."""

    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 cube_size: int = 32, patch_size: int = 96,
                 n_filters: int = 16, ndim: int = 3,
                 normalization: str = "instancenorm",
                 has_dropout: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cube_size, self.patch_size = cube_size, patch_size
        kw = dict(n_filters=n_filters, ndim=ndim,
                  normalization=normalization, has_dropout=has_dropout,
                  device=device, generator=generator)
        self.encoder = VNetEncoder(in_chans, **kw)
        self.decoder = VNetDecoder(num_classes, **kw)
        self.fc_layer = FcLayer(16 * n_filters * (cube_size // 16) ** ndim,
                                cube_size, patch_size, ndim, device=device,
                                generator=generator)

    def forward_encoder(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [channels_last(f)
                for f in self.encoder(channels_first(x))]

    def forward_decoder(self, feats: Sequence[torch.Tensor]):
        seg, emb = self.decoder([channels_first(f) for f in feats])
        return channels_last(seg), channels_last(emb)

    def forward_location(self, flat: torch.Tensor) -> torch.Tensor:
        return self.fc_layer(flat)

    def forward_prediction_head(self, emb: torch.Tensor) -> torch.Tensor:
        return channels_last(self.decoder.head(channels_first(emb)))

    def forward(self, x: torch.Tensor):
        seg, emb = self.decoder(self.encoder(channels_first(x)))
        return channels_last(seg), channels_last(emb)


def _renamed(kw: dict) -> dict:
    if "class_num" in kw:
        kw["num_classes"] = kw.pop("class_num")
    return kw


def vnet_2d(**kw) -> VNet:
    """``vnet``: the 2-D VNet_2D, instance norm."""
    kw.setdefault("ndim", 2)
    kw.setdefault("normalization", "instancenorm")
    return VNet(**_renamed(kw))


def vnet_3d(**kw) -> VNet:
    """``vnet_3D``: batch norm, dropout 0.5."""
    kw.setdefault("ndim", 3)
    kw.setdefault("normalization", "batchnorm")
    kw.setdefault("has_dropout", True)
    return VNet(**_renamed(kw))


def magicnet_3d(**kw) -> VNetMagic:
    """``magicnet``: the 3-D VNet_Magic."""
    kw.setdefault("ndim", 3)
    return VNetMagic(**_renamed(kw))


def magicnet_2d(**kw) -> VNetMagic:
    """``magicnet_2D``."""
    kw.setdefault("ndim", 2)
    return VNetMagic(**_renamed(kw))
