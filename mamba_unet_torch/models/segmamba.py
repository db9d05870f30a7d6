"""SegMamba: a 3-D segmentation net whose encoder mixes tokens with 1-D
bidirectional Mamba layers over the flattened D*H*W tokens; and the
UNETR-style decoder blocks that UNETR and SwinUNETR share with it.

Port of ``mamba_unet_tpu/models/segmamba.py`` (the reference's
``segmamba.py``): a 7^3/2 conv stem and three 2^3/2 conv downsamples, four
stages of [LayerNorm -> ``Mamba(bimamba_type="v2")``] over the stage's
tokens (no residual, as there), per-stage LayerNorm + channel MLP taps,
and the decoder of residual conv blocks (conv -> instance norm ->
leaky ReLU, MONAI's ``UnetrBasicBlock``) and transposed-conv upsampling
(``UnetrUpBlock``). The Mamba layers are the port's
``nn/mamba1d.py::Mamba``: its time-major grouped scan, one group per
direction, launches the CUDA kernels ``csrc/selective_scan_fwd.cu`` (the
forward, with no gradient or state-saving) and ``csrc/selective_scan_bwd.cu``
(its backward) on CUDA tensors: the 1-D Mamba's only route, so there is
no ``scan_impl`` here.

Images come in channels-last, (B, *spatial, C), and logits go out as fp32
channels-last; ``ndim`` is 3 (volumes, the default) or 2, and an input of
another rank raises ``ValueError`` (the JAX module's convs would read a
2-D slice batch's batch axis as depth). Module and parameter names are the
flax module's (``stem``, ``stage{i}_mamba{j}.mamba``, ``encoder1``,
``decoder5.ConvTranspose_0``, ...), so ``utils/convert.py::params_from_jax``
maps them one to one; the Mamba parameters have the upstream
``mamba_simple.py`` names (``A_b_log``, ``conv1d_b``, ``x_proj_b``,
``dt_proj_b``, ``D_b``). Instance norm is flax's ``GroupNorm(group_size=1)``
(epsilon 1e-6, fast variance), the leaky ReLU flax's (gradient 1 at 0),
GELU its tanh approximation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.vnet import (
    channels_first,
    channels_last,
    conv,
    conv_transpose,
)
from mamba_unet_torch.nn.layers import GroupNorm, leaky_relu
from mamba_unet_torch.nn.mamba1d import Mamba


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def check_rank(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.dim() != ndim + 2:
        shape = "(B, D, H, W, C)" if ndim == 3 else "(B, H, W, C)"
        raise ValueError(f"{name} (ndim={ndim}) takes {shape} channels-last "
                         f"input, got shape {tuple(x.shape)}")


class UnetrBasicBlock(nn.Module):
    """2 x [conv 3 -> instance norm -> leaky ReLU] with a residual (a 1^n
    conv + norm where the width changes); channels-first."""

    def __init__(self, cin: int, features: int, ndim: int = 3,
                 res_block: bool = True, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Conv_0 = conv(ndim, cin, features, 3, padding=1, **kw)
        self.GroupNorm_0 = GroupNorm(features, group_size=1, device=device)
        self.Conv_1 = conv(ndim, features, features, 3, padding=1, **kw)
        self.GroupNorm_1 = GroupNorm(features, group_size=1, device=device)
        self.res_block = res_block
        self.project = res_block and cin != features
        if self.project:
            self.Conv_2 = conv(ndim, cin, features, 1, **kw)
            self.GroupNorm_2 = GroupNorm(features, group_size=1,
                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.GroupNorm_0(self.Conv_0(x)))
        h = self.GroupNorm_1(self.Conv_1(h))
        if self.res_block:
            if self.project:
                x = self.GroupNorm_2(self.Conv_2(x))
            h = h + x
        return leaky_relu(h)


class UnetrUpBlock(nn.Module):
    """Transposed conv x2 -> concat skip -> :class:`UnetrBasicBlock`;
    channels-first."""

    def __init__(self, cin: int, skip: int, features: int, ndim: int = 3, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ConvTranspose_0 = conv_transpose(ndim, cin, features, 2, **kw)
        self.UnetrBasicBlock_0 = UnetrBasicBlock(features + skip, features,
                                                 ndim, **kw)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.ConvTranspose_0(x), skip], dim=1)
        return self.UnetrBasicBlock_0(x)


class MambaLayer(nn.Module):
    """LayerNorm + bidirectional Mamba over the flattened spatial tokens,
    channels-last in and out (no residual)."""

    def __init__(self, dim: int, d_state: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mamba = Mamba(dim, d_state, bimamba_type="v2", device=device,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x.reshape(x.shape[0], -1, x.shape[-1])
        h = self.mamba(self.LayerNorm_0(tokens))
        return h.reshape(x.shape)


class MlpChannel(nn.Module):
    """1^n conv -> GELU -> 1^n conv; channels-first."""

    def __init__(self, dim: int, hidden: int, ndim: int = 3, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.Conv_0 = conv(ndim, dim, hidden, 1, **kw)
        self.Conv_1 = conv(ndim, hidden, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(gelu(self.Conv_0(x)))


class SegMamba(nn.Module):
    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 feat_size: Sequence[int] = (48, 96, 192, 384),
                 hidden_size: int = 16, d_state: int = 16, ndim: int = 3,
                 *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {ndim}")
        self.ndim = ndim
        self.depths = tuple(depths)
        f = list(feat_size)
        kw = dict(device=device, generator=generator)
        self.stem = conv(ndim, in_chans, f[0], 7, stride=2, padding=3, **kw)
        self.stem_norm = nn.LayerNorm(f[0], eps=1e-6, device=device)
        for i in range(4):
            if i:
                self.add_module(f"down_norm{i}", nn.LayerNorm(
                    f[i - 1], eps=1e-6, device=device))
                self.add_module(f"down{i}", conv(ndim, f[i - 1], f[i], 2,
                                                 stride=2, **kw))
            for j in range(depths[i]):
                self.add_module(f"stage{i}_mamba{j}",
                                MambaLayer(f[i], d_state, **kw))
            self.add_module(f"norm{i}", nn.LayerNorm(f[i], eps=1e-6,
                                                     device=device))
            self.add_module(f"mlp{i}", MlpChannel(f[i], 4 * f[i], ndim,
                                                  **kw))
        blk = dict(ndim=ndim, **kw)
        self.encoder1 = UnetrBasicBlock(in_chans, f[0], **blk)
        self.encoder2 = UnetrBasicBlock(f[0], f[1], **blk)
        self.encoder3 = UnetrBasicBlock(f[1], f[2], **blk)
        self.encoder4 = UnetrBasicBlock(f[2], f[3], **blk)
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size, **blk)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3], f[3], **blk)
        self.decoder4 = UnetrUpBlock(f[3], f[2], f[2], **blk)
        self.decoder3 = UnetrUpBlock(f[2], f[1], f[1], **blk)
        self.decoder2 = UnetrUpBlock(f[1], f[0], f[0], **blk)
        self.decoder1 = UnetrBasicBlock(f[0], f[0], **blk)
        self.out = conv(ndim, f[0], num_classes, 1, **kw)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        """(B, *spatial, C) -> (B, *spatial, classes) fp32 logits."""
        check_rank(x_in, self.ndim, "SegMamba")
        xf = channels_first(x_in)
        outs, x = [], None
        for i in range(4):
            if i == 0:
                x = self.stem_norm(channels_last(self.stem(xf)))
            else:
                x = getattr(self, f"down_norm{i}")(x)
                x = channels_last(getattr(self, f"down{i}")(
                    channels_first(x)))
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i}_mamba{j}")(x)
            tap = channels_first(getattr(self, f"norm{i}")(x))
            outs.append(getattr(self, f"mlp{i}")(tap))
        enc1 = self.encoder1(xf)
        enc2 = self.encoder2(outs[0])
        enc3 = self.encoder3(outs[1])
        enc4 = self.encoder4(outs[2])
        hidden = self.encoder5(outs[3])
        d = self.decoder5(hidden, enc4)
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        d = self.decoder1(d)
        return channels_last(self.out(d)).float()
