"""The MagicNet mask heads: the position/mask embedding and the global
mix-out head of shuffle/mask-recovery pretraining.

Port of ``PosEmbedLayer`` and ``MixOutLayer`` from
``mamba_unet_tpu/models/magicnet_mask.py`` (channels-last); its
``VNetMagicMask`` is not ported yet. Each head's BatchNorm is flax's and
is named ``bn``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.vnet import dense
from mamba_unet_torch.nn.layers import BatchNorm1d, lecun_normal_


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, *size, C), bilinear with anti-aliasing, in fp32:
    ``jax.image.resize(method="bilinear")``, whose ``antialias`` defaults
    to True (the same triangle filter, widened by the scale when
    downsampling)."""
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class PosEmbedLayer(nn.Module):
    """Cube position ids and visibility mask -> MLP -> a (patch_size)²
    multiplicative embedding of the image, resized to the input's size
    when that differs (the cubes of the location pass)."""

    def __init__(self, cube_size: int = 32, patch_size: int = 96, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cube_size, self.patch_size = cube_size, patch_size
        self.n_ids = (patch_size // cube_size) ** 2
        self.fc1 = dense(2 * self.n_ids, 256, device, generator)
        self.bn = BatchNorm1d(256, device=device)
        self.fc2 = dense(256, patch_size * patch_size, device, generator)

    def forward(self, x: torch.Tensor, pos_embed=None, mask=None
                ) -> torch.Tensor:
        """``x`` (B, H, W, C); ``pos_embed``, ``mask`` (B, ids) or None (the
        identity ids, every cube visible)."""
        b = x.shape[0]
        for name, given in (("pos_embed", pos_embed), ("mask", mask)):
            if given is not None and given.shape[-1] != self.n_ids:
                raise ValueError(
                    f"{name} holds {given.shape[-1]} cube ids, but this "
                    f"layer was built for patch_size {self.patch_size} and "
                    f"cube_size {self.cube_size}: {self.n_ids} ids; a "
                    f"perturbed input of {x.shape[1]}x{x.shape[2]} needs a "
                    f"model built for patch_size {x.shape[1]}")
        if pos_embed is None:
            pos_embed = torch.arange(self.n_ids, device=x.device).expand(
                b, -1)
        if mask is None:
            mask = torch.ones(b, self.n_ids, device=x.device)
        pm = torch.cat([pos_embed.float(), mask.float()], dim=1)
        h = F.leaky_relu(self.bn(self.fc1(pm)), 0.2)
        embed = self.fc2(h).reshape(b, self.patch_size, self.patch_size, 1)
        if self.patch_size != x.shape[1]:
            embed = resize_bilinear(embed, x.shape[1:3])
        return x * embed.to(x.dtype)


class MixOutLayer(nn.Module):
    """The decoder's (B, H, W, channels) embedding -> 5x5 stride-5 conv to
    one channel -> Dense(256) -> BatchNorm -> LeakyReLU(0.2): a (B, 256)
    global vector. The Dense's input, which flax infers, is the conv's
    output at ``patch_size``."""

    def __init__(self, patch_size: int = 96, channels: int = 16, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 5, stride=5, padding=2,
                              device=device)
        lecun_normal_(self.conv.weight, generator)
        nn.init.zeros_(self.conv.bias)
        side = (patch_size + 4 - 5) // 5 + 1
        self.fc = dense(side * side, 256, device, generator)
        self.bn = BatchNorm1d(256, device=device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        h = self.conv(emb.permute(0, 3, 1, 2)).flatten(1)
        return F.leaky_relu(self.bn(self.fc(h)), 0.2)
