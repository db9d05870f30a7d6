"""UNETR: a 3-D ViT-encoder UNet.

Port of ``mamba_unet_tpu/models/unetr.py`` (the reference's MONAI-backed
``unetr.py``: img 96^3, patch 16, hidden 768, 12 layers x 12 heads, mlp
3072, feature size 16, taps after transformer layers 3/6/9/12): a patch
conv embedding plus a learned position embedding, pre-norm blocks of
multi-head attention (flax ``MultiHeadDotProductAttention``: query, key,
value and out projections with bias, queries scaled by 1/sqrt(head dim))
and a GELU MLP, and the decoder: transposed-conv chains (``PrUpBlock``)
that bring the tapped token grids to /2, /4 and /8, and
``UnetrUpBlock``/``UnetrBasicBlock`` (``models/segmamba.py``).

The position embedding has one row per token of an ``img_size``^3 input:
the model is built for that size (the flax module sizes it at init from
its input). Volumes come in channels-last, (B, D, H, W, C), and logits go
out as fp32 channels-last. Module names are the flax module's
(``patch_embed``, ``pos_embed``, ``vit_{i}``, ``encoder1``-``4``,
``decoder5``-``2``, ``out``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mamba_unet_torch.models.segmamba import (
    UnetrBasicBlock,
    UnetrUpBlock,
    check_rank,
    gelu,
)
from mamba_unet_torch.models.vnet import (
    channels_first,
    channels_last,
    conv,
    conv_transpose,
)
from mamba_unet_torch.nn.layers import linear, trunc_normal_


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention: (B, N, C) -> (B, N, C)."""

    def __init__(self, dim: int, heads: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, linear(dim, dim, True, device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = (getattr(self, name)(x).reshape(b, n, self.heads, -1)
                   .transpose(1, 2) for name in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((attn @ v).transpose(1, 2).reshape(b, n, c))


class ViTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden, heads, device=device, generator=generator)
        self.LayerNorm_1 = nn.LayerNorm(hidden, eps=1e-5, device=device)
        self.Dense_0 = linear(hidden, mlp_dim, True, device, generator)
        self.Dense_1 = linear(mlp_dim, hidden, True, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        return x + self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))


class PrUpBlock(nn.Module):
    """num_layer + 1 transposed convs x2, each after the first followed by
    a :class:`UnetrBasicBlock`; channels-first."""

    def __init__(self, cin: int, features: int, num_layer: int, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_layer = num_layer
        self.ConvTranspose_0 = conv_transpose(3, cin, features, 2, **kw)
        for i in range(num_layer):
            self.add_module(f"ConvTranspose_{i + 1}", conv_transpose(
                3, features, features, 2, **kw))
            self.add_module(f"UnetrBasicBlock_{i}", UnetrBasicBlock(
                features, features, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(x)
        for i in range(self.num_layer):
            x = getattr(self, f"ConvTranspose_{i + 1}")(x)
            x = getattr(self, f"UnetrBasicBlock_{i}")(x)
        return x


class UNETR(nn.Module):
    def __init__(self, num_classes: int = 14, in_chans: int = 1,
                 img_size: int = 96, patch_size: int = 16,
                 hidden: int = 768, mlp_dim: int = 3072, heads: int = 12,
                 n_layers: int = 12, feature_size: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_layers < 12:
            raise ValueError(f"UNETR taps transformer layers 3/6/9/12; "
                             f"n_layers={n_layers}")
        kw = dict(device=device, generator=generator)
        p, fs = patch_size, feature_size
        self.patch_size, self.hidden, self.n_layers = p, hidden, n_layers
        self.grid = img_size // p
        self.patch_embed = conv(3, in_chans, hidden, p, stride=p, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid ** 3, hidden,
                                                  device=device))
        trunc_normal_(self.pos_embed, generator=generator)
        for i in range(n_layers):
            self.add_module(f"vit_{i}", ViTBlock(hidden, heads, mlp_dim,
                                                 **kw))
        self.encoder1 = UnetrBasicBlock(in_chans, fs, **kw)
        self.encoder2 = PrUpBlock(hidden, 2 * fs, 2, **kw)
        self.encoder3 = PrUpBlock(hidden, 4 * fs, 1, **kw)
        self.encoder4 = PrUpBlock(hidden, 8 * fs, 0, **kw)
        self.decoder5 = UnetrUpBlock(hidden, 8 * fs, 8 * fs, **kw)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, 4 * fs, **kw)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, 2 * fs, **kw)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, fs, **kw)
        self.out = conv(3, fs, num_classes, 1, **kw)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        check_rank(x_in, 3, "UNETR")
        b, grid = x_in.shape[0], tuple(s // self.patch_size
                                       for s in x_in.shape[1:4])
        if grid != (self.grid,) * 3:
            raise ValueError(f"UNETR built for {self.grid}^3 tokens "
                             f"(img_size {self.grid * self.patch_size}), "
                             f"got a {tuple(x_in.shape[1:4])} input")
        xf = channels_first(x_in)
        tokens = channels_last(self.patch_embed(xf)).reshape(
            b, -1, self.hidden)
        h = tokens + self.pos_embed.to(tokens.dtype)
        taps = {}
        for i in range(self.n_layers):
            h = getattr(self, f"vit_{i}")(h)
            if i + 1 in (3, 6, 9, 12):
                taps[i + 1] = channels_first(h.reshape(b, *grid,
                                                       self.hidden))
        enc1 = self.encoder1(xf)
        enc2 = self.encoder2(taps[3])
        enc3 = self.encoder3(taps[6])
        enc4 = self.encoder4(taps[9])
        d = self.decoder5(taps[12], enc4)
        d = self.decoder4(d, enc3)
        d = self.decoder3(d, enc2)
        d = self.decoder2(d, enc1)
        return channels_last(self.out(d)).float()
