"""SwinUNETR: a 3-D shifted-window Swin encoder with a UNETR decoder.

Port of ``mamba_unet_tpu/models/swin_unetr.py`` (MONAI's ``SwinUNETR`` as
the reference's 3-D factory builds it, feature size 48): a patch-2 conv
embedding, four Swin stages (depths (2, 2, 2, 2), heads (3, 6, 12, 24),
window 7) with 3-D cyclic shifts and their attention masks, a relative
position bias table per block, patch merging (the 8 parities of each 2^3
cell concatenated, LayerNorm, a linear to twice the width), and the
UNETR residual-conv decoder (``models/segmamba.py``) fed by every stage's
input and the bottleneck.

A block's window shrinks to its map, and does not shift, where the map is
no larger than the window, so the bias tables' sizes follow the input:
the model is built for ``img_size``^3 inputs (the flax module sizes them
at init from its input), and another size raises ``ValueError``. As in the
JAX module there is no padding: every stage map (img_size / 2, / 4, / 8,
/ 16) must tile into its window and the last one be even, e.g. window 7
at img_size 224k, window 6 or 4 at 96. Volumes come in channels-last, (B,
D, H, W, C), and logits go out as fp32 channels-last; the attention logits
and their softmax are fp32 (the JAX einsum's ``preferred_element_type``).
Module names are the flax module's (``patch_embed``,
``stage{i}_block{j}`` with ``norm1``, ``qkv``, ``rel_bias``, ``proj``,
``norm2``, ``fc1``, ``fc2``; ``merge{i}``; ``encoder0``-``4``;
``decoder4``-``0``; ``out``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mamba_unet_torch.models.segmamba import (
    UnetrBasicBlock,
    UnetrUpBlock,
    check_rank,
    gelu,
)
from mamba_unet_torch.models.vnet import channels_first, channels_last, conv
from mamba_unet_torch.nn.layers import linear, trunc_normal_


def window_partition_3d(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nWindows, ws^3, C)."""
    b, D, H, W, c = x.shape
    x = x.reshape(b, D // ws, ws, H // ws, ws, W // ws, ws, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws ** 3, c)


def window_reverse_3d(wins: torch.Tensor, ws: int, D: int, H: int, W: int
                      ) -> torch.Tensor:
    """Inverse of :func:`window_partition_3d`."""
    c = wins.shape[-1]
    b = wins.shape[0] // ((D // ws) * (H // ws) * (W // ws))
    x = wins.reshape(b, D // ws, H // ws, W // ws, ws, ws, ws, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, D, H, W, c)


def rel_index_3d(ws: int) -> np.ndarray:
    """(ws^3, ws^3) index into the (2 ws - 1)^3 bias table."""
    coords = np.stack(np.meshgrid(*([np.arange(ws)] * 3), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel += ws - 1
    return (rel[..., 0] * (2 * ws - 1) ** 2 + rel[..., 1] * (2 * ws - 1)
            + rel[..., 2])


def shift_mask_3d(D: int, H: int, W: int, ws: int, shift: int
                  ) -> Optional[np.ndarray]:
    """(nWindows, ws^3, ws^3) additive mask (0 or -100) of the shifted
    windows, or None without a shift."""
    if shift == 0:
        return None
    m = np.zeros((D, H, W), np.float32)
    cnt = 0
    sl = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for a in sl:
        for b in sl:
            for c in sl:
                m[a, b, c] = cnt
                cnt += 1
    wins = window_partition_3d(torch.from_numpy(m)[None, ..., None],
                               ws)[..., 0].numpy()
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def effective_window(size: int, window: int, shift: int):
    """The (window, shift) a block uses on a map of side ``size``."""
    return (size, 0) if size <= window else (window, shift)


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, size: int,
                 window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """``size``: the side of the (cubic) map the block is built for."""
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.ws, self.shift = effective_window(size, window_size, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.qkv = linear(dim, 3 * dim, True, device, generator)
        self.rel_bias = nn.Parameter(torch.empty(
            (2 * self.ws - 1) ** 3, num_heads, device=device))
        trunc_normal_(self.rel_bias, generator=generator)
        self.proj = linear(dim, dim, True, device, generator)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.fc1 = linear(dim, int(dim * mlp_ratio), True, device, generator)
        self.fc2 = linear(int(dim * mlp_ratio), dim, True, device, generator)
        self.register_buffer("rel_index", torch.from_numpy(
            rel_index_3d(self.ws).reshape(-1)), persistent=False)
        self._masks = {}

    def _mask(self, D: int, H: int, W: int, device) -> torch.Tensor:
        key = (D, H, W, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_mask_3d(
                D, H, W, self.ws, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, D, H, W, c = x.shape
        ws, shift = self.ws, self.shift
        if (effective_window(min(D, H, W), self.window_size, 0)[0] != ws
                or D % ws or H % ws or W % ws):
            raise ValueError(f"SwinBlock3D built for window {ws}: a "
                             f"{(D, H, W)} map does not tile into it")
        nh = self.num_heads
        hd = c // nh
        shortcut = x
        x = self.norm1(x)
        if shift:
            x = torch.roll(x, (-shift,) * 3, dims=(1, 2, 3))
        wins = window_partition_3d(x, ws)
        n = wins.shape[1]
        qkv = self.qkv(wins).reshape(-1, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = q.float() @ k.float().transpose(-1, -2)
        bias = self.rel_bias[self.rel_index].reshape(n, n, nh).permute(
            2, 0, 1)
        attn = attn + bias[None].float()
        if shift:
            mask = self._mask(D, H, W, x.device)
            nw = mask.shape[0]
            attn = (attn.reshape(-1, nw, nh, n, n)
                    + mask[None, :, None]).reshape(-1, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(-1, n, c)
        x = window_reverse_3d(self.proj(out), ws, D, H, W)
        if shift:
            x = torch.roll(x, (shift,) * 3, dims=(1, 2, 3))
        x = shortcut + x
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class PatchMerging3D(nn.Module):
    def __init__(self, dim: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=1e-5, device=device)
        self.reduction = linear(8 * dim, 2 * dim, False, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x[:, i::2, j::2, k::2] for i in range(2) for j in range(2)
                 for k in range(2)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class SwinUNETR(nn.Module):
    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 img_size: int = 96, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        fs = feature_size
        self.img_size, self.depths = img_size, tuple(depths)
        self.patch_embed = conv(3, in_chans, fs, 2, stride=2, **kw)
        dim, size = fs, img_size // 2
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock3D(
                    dim, heads, size, window_size,
                    0 if j % 2 == 0 else window_size // 2, **kw))
            self.add_module(f"merge{i}", PatchMerging3D(dim, **kw))
            dim, size = 2 * dim, size // 2
        blk = dict(ndim=3, **kw)
        self.encoder0 = UnetrBasicBlock(in_chans, fs, **blk)
        self.encoder1 = UnetrBasicBlock(fs, fs, **blk)
        self.encoder2 = UnetrBasicBlock(2 * fs, 2 * fs, **blk)
        self.encoder3 = UnetrBasicBlock(4 * fs, 4 * fs, **blk)
        self.encoder4 = UnetrBasicBlock(8 * fs, 8 * fs, **blk)
        self.decoder4 = UnetrUpBlock(16 * fs, 8 * fs, 8 * fs, **blk)
        self.decoder3 = UnetrUpBlock(8 * fs, 4 * fs, 4 * fs, **blk)
        self.decoder2 = UnetrUpBlock(4 * fs, 2 * fs, 2 * fs, **blk)
        self.decoder1 = UnetrUpBlock(2 * fs, fs, fs, **blk)
        self.decoder0 = UnetrUpBlock(fs, fs, fs, **blk)
        self.out = conv(3, fs, num_classes, 1, **kw)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        check_rank(x_in, 3, "SwinUNETR")
        if tuple(x_in.shape[1:4]) != (self.img_size,) * 3:
            raise ValueError(f"SwinUNETR built for {self.img_size}^3 inputs "
                             f"(its windows and bias tables), got "
                             f"{tuple(x_in.shape[1:4])}")
        xf = channels_first(x_in)
        x = channels_last(self.patch_embed(xf))
        taps = []
        for i, depth in enumerate(self.depths):
            taps.append(channels_first(x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
            x = getattr(self, f"merge{i}")(x)
        enc0 = self.encoder0(xf)
        enc1 = self.encoder1(taps[0])
        enc2 = self.encoder2(taps[1])
        enc3 = self.encoder3(taps[2])
        enc4 = self.encoder4(taps[3])
        d = self.decoder4(channels_first(x), enc4)
        d = self.decoder3(d, enc3)
        d = self.decoder2(d, enc2)
        d = self.decoder1(d, enc1)
        d = self.decoder0(d, enc0)
        return channels_last(self.out(d)).float()
