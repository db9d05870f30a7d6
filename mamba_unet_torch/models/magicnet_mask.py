"""The MagicNet mask heads (the position/mask embedding and the global
mix-out head of shuffle/mask-recovery pretraining) and the 2-D VNet_Magic
that carries them.

Port of ``PosEmbedLayer``, ``MixOutLayer`` and ``VNetMagicMask``
(registry ``magicnet_2D_mask``) from
``mamba_unet_tpu/models/magicnet_mask.py``, channels-last. Each head's
BatchNorm is flax's and is named ``bn``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.vnet import (
    FcLayer,
    VNetDecoder,
    VNetEncoder,
    dense,
)
from mamba_unet_torch.nn.layers import BatchNorm1d, lecun_normal_, leaky_relu


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
        # fp32 ids (fp64 beside an fp64 image)
        pm = torch.cat([pos_embed, mask], dim=1).to(
            torch.promote_types(x.dtype, torch.float32))
        h = leaky_relu(self.bn(self.fc1(pm)), 0.2)
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
        return leaky_relu(self.bn(self.fc(h)), 0.2)


class VNetMagicMask(nn.Module):
    """The 2-D ``VNetMagic`` (``models/vnet.py``) with the position/mask
    embedding in front of its encoder and the mix-out head on its
    embedding; every tensor in and out is channels-last:

      forward(x, pos_embed, mask)      -> (seg logits fp32, embedding)
      forward_encoder(x, pos, mask)    -> [x1 .. x5]
      forward_decoder(feats)           -> (seg logits fp32, embedding)
      forward_location(flat)           -> cube-location logits
      forward_prediction_head(e)       -> seg logits fp32
      forward_mix_pos_mask(x, ...)     -> (B, 256) global embedding

    ``patch_size`` sizes the position embedding and the mix-out head;
    every head exists from construction."""

    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 cube_size: int = 32, patch_size: int = 96,
                 n_filters: int = 16, normalization: str = "instancenorm", *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cube_size, self.patch_size = cube_size, patch_size
        kw = dict(n_filters=n_filters, ndim=2, normalization=normalization,
                  device=device, generator=generator)
        self.encoder = VNetEncoder(in_chans, **kw)
        self.decoder = VNetDecoder(num_classes, **kw)
        self.fc_layer = FcLayer(16 * n_filters * (cube_size // 16) ** 2,
                                cube_size, patch_size, 2, device=device,
                                generator=generator)
        self.pos_embed_layer = PosEmbedLayer(cube_size, patch_size,
                                             device=device,
                                             generator=generator)
        self.mix_out_layer = MixOutLayer(patch_size, n_filters,
                                         device=device, generator=generator)

    def _decode(self, feats):
        seg, emb = self.decoder(feats)
        return seg.permute(0, 2, 3, 1), emb.permute(0, 2, 3, 1)

    def forward_encoder(self, x: torch.Tensor, pos_embed=None, mask=None
                        ) -> List[torch.Tensor]:
        x = self.pos_embed_layer(x, pos_embed, mask)
        return [f.permute(0, 2, 3, 1)
                for f in self.encoder(x.permute(0, 3, 1, 2))]

    def forward_decoder(self, feats: Sequence[torch.Tensor]):
        return self._decode([f.permute(0, 3, 1, 2) for f in feats])

    def forward_location(self, flat: torch.Tensor) -> torch.Tensor:
        return self.fc_layer(flat)

    def forward_prediction_head(self, emb: torch.Tensor) -> torch.Tensor:
        return self.decoder.head(emb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward_mix_pos_mask(self, x: torch.Tensor, pos_embed=None,
                             mask=None) -> torch.Tensor:
        _, emb = self(x, pos_embed, mask)
        return self.mix_out_layer(emb)

    def forward(self, x: torch.Tensor, pos_embed=None, mask=None):
        x = self.pos_embed_layer(x, pos_embed, mask)
        return self._decode(self.encoder(x.permute(0, 3, 1, 2)))
