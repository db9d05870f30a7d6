"""Swin transformer blocks (window attention, shifted windows), channels-last.

Port of ``mamba_unet_tpu/nn/swin.py``: ``WindowAttention`` (relative
position bias), ``SwinBlock`` (cyclic shift and its attention mask) and
``SwinStage`` (blocks alternating shift 0 / ws // 2, then the stage's
down/upsample op, which the stage owns here as the VSS stages do, so the
parameter names are the upstream checkpoints': ``layers.{i}.blocks.{j}.
{norm1, attn.qkv, attn.proj, attn.relative_position_bias_table, norm2,
mlp.fc1, mlp.fc2}``, ``layers.{i}.downsample``).

Window partitioning is reshapes. A block's window and shift follow the map
it is built for: where the map is no larger than the window, the window
shrinks to the map and does not shift. The relative position index and the
shift mask are non-persistent buffers, so a ``state_dict`` holds what the
flax parameters hold. The attention logits and their softmax are fp32, also
under bf16 autocast, as the JAX einsum's ``preferred_element_type`` makes
them; the MLP's GELU is the tanh approximation (``flax.linen.gelu``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import DropPath, Dropout, linear, trunc_normal_
from mamba_unet_torch.nn.patch_ops import PatchExpand2D, PatchMerging2D


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nWindows, ws * ws, C)."""
    bsz, H, W, c = x.shape
    x = x.reshape(bsz, H // ws, ws, W // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    c = wins.shape[-1]
    bsz = wins.shape[0] // (H // ws * (W // ws))
    x = wins.reshape(bsz, H // ws, W // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(bsz, H, W, c)


def _relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2 ws - 1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int
                     ) -> Optional[np.ndarray]:
    """(nW, ws², ws²) additive 0 / -100 mask of the shifted windows, or
    None without a shift."""
    if shift == 0:
        return None
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, h, w, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_and_shift(H: int, W: int, window_size: int, shift_size: int
                     ) -> Tuple[int, int]:
    """The (window, shift) a block uses on an H x W map: the window covers
    a map no larger than it, without a shift."""
    if min(H, W) <= window_size:
        return min(H, W), 0
    return window_size, shift_size


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = linear(dim, 3 * dim, qkv_bias, device, generator)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads, device=device))
        trunc_normal_(self.relative_position_bias_table, generator=generator)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size).reshape(
                -1)).to(device), persistent=False)
        self.attn_drop = Dropout(attn_drop)
        self.proj = linear(dim, dim, True, device, generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (nW * B, N, C); mask: (nW, N, N) additive, or None."""
        nb, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(nb, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        # fp32 logits and softmax whatever the compute dtype
        with torch.autocast(x.device.type, enabled=False):
            attn = q.float() @ k.float().transpose(-2, -1)
            bias = self.relative_position_bias_table[
                self.relative_position_index].reshape(n, n, nh)
            attn = attn + bias.permute(2, 0, 1).float()
            if mask is not None:
                nw = mask.shape[0]
                attn = (attn.reshape(nb // nw, nw, nh, n, n)
                        + mask[None, :, None]).reshape(nb, nh, n, n)
            attn = torch.softmax(attn, dim=-1)
        attn = self.attn_drop(attn.to(v.dtype))
        out = (attn @ v).transpose(1, 2).reshape(nb, n, c)
        return self.proj_drop(self.proj(out))


class Mlp(nn.Module):
    """fc1 -> tanh-approximated GELU -> Dropout -> fc2 -> Dropout."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = linear(dim, hidden, True, device, generator)
        self.fc2 = linear(hidden, dim, True, device, generator)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(self.fc1(x), approximate="tanh"))
        return self.drop(self.fc2(x))


class SwinBlock(nn.Module):
    """x + DropPath(shifted-window attention(LN(x))), then
    x + DropPath(MLP(LN(x))), on the ``input_resolution`` map it is built
    for."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        H, W = input_resolution
        self.window_size, self.shift_size = window_and_shift(
            H, W, window_size, shift_size)
        if H % self.window_size or W % self.window_size:
            raise ValueError(
                f"a {H}x{W} map does not tile into {self.window_size}x"
                f"{self.window_size} windows: build the model for an image "
                f"size whose every stage map does (224 for window 7)")
        self.input_resolution = (H, W)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.attn = WindowAttention(dim, self.window_size, num_heads,
                                    attn_drop=attn_drop, proj_drop=drop,
                                    device=device, generator=generator)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, device=device,
                       generator=generator)
        mask = _shift_attn_mask(H, W, self.window_size, self.shift_size)
        self.register_buffer(
            "attn_mask", None if mask is None else
            torch.from_numpy(mask).to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        if (H, W) != self.input_resolution:
            raise ValueError(f"SwinBlock built for a {self.input_resolution} "
                             f"map got {(H, W)}: build the model for this "
                             f"image size")
        ws, shift = self.window_size, self.shift_size
        y = self.norm1(x)
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask),
                           ws, H, W)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class SwinStage(nn.Module):
    """depth x SwinBlock, alternating shift 0 / ws // 2, then an optional
    PatchMerging2D (encoder stage) or PatchExpand2D (decoder stage)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = (),
                 downsample: bool = False, upsample: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio, drop,
                      attn_drop, drop_path[i] if i < len(drop_path) else 0.0,
                      **kw)
            for i in range(depth))
        self.downsample = PatchMerging2D(dim, **kw) if downsample else None
        self.upsample = PatchExpand2D(dim, **kw) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        if self.downsample is not None:
            x = self.downsample(x)
        if self.upsample is not None:
            x = self.upsample(x)
        return x
