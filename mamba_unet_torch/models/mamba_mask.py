"""MambaUnetMask: the visual-Mamba UNet with MagicNet's mask heads.

Port of ``mamba_unet_tpu/models/mamba_mask.py``: ``ViM_seg``'s network
split into an encoder and a decoder, with the position/mask embedding and
the mix-out head of ``models/magicnet_mask.py`` and the cube-location
classifier ``models/vnet.py::FcLayer``. The methods the mask-pretraining
and contrastive-mask trainers drive (channels-last throughout):

  forward(x, pos_embed, mask)  -> (seg logits fp32, 16-ch embedding)
  forward_prediction_head(e)   -> logits (the 1x1 conv on the embedding)
  forward_encoder(x, ...)      -> [skip0 .. skip3, normed bottleneck]
  forward_decoder(feats)       -> (logits, embedding)
  forward_location(flat)       -> cube-location logits
  forward_mix_pos_mask(x, ...) -> (B, 256) global embedding

Every head exists from construction (the JAX model creates the location
and mix-out heads only through ``init_all``). The decoder ends in the x4
``FinalPatchExpand2D`` at ``dims[0]`` channels, a 3x3 conv to the
16-channel embedding and the 1x1 prediction conv; the location head reads
the flattened bottleneck of one cube: patch embedding (/4) and three
merges (/8) take a 32² cube to 1x1 x dims[-1] (its input size assumes
four stages, as in the JAX model). A grey input is repeated to
3 channels after the position embedding. Every SS2D runs the
``scan_impl`` branch, as in ``ViM_seg``.

Module names: ``encoder.{patch_embed, layers.i, norm}`` as ``VSSM``'s,
``decoder.layers_up.0`` the first expand, ``decoder.layers_up.i`` (i >= 1)
decoder stage i - 1 with its upsample, ``decoder.concat_back_dim.i`` the
Linear before stage i, then ``norm_up``, ``up``, ``emb_conv``,
``out_conv``; ``fc_layer``, ``pos_embed_layer``, ``mix_out_layer``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.magicnet_mask import MixOutLayer, PosEmbedLayer
from mamba_unet_torch.models.vnet import FcLayer
from mamba_unet_torch.nn.layers import lecun_normal_, linear
from mamba_unet_torch.nn.patch_ops import (
    FinalPatchExpand2D,
    PatchEmbed2D,
    PatchExpand2D,
)
from mamba_unet_torch.nn.vss import VSSLayer

PATCH_SIZE = 4  # patch embedding stride and final expand scale


def _stage_drop_paths(depths: Sequence[int], rate: float) -> List[list]:
    """Stochastic depth 0 -> ``rate`` over the encoder blocks, per stage."""
    dpr = np.linspace(0, rate, sum(depths)).tolist()
    offs = np.cumsum([0, *depths]).tolist()
    return [dpr[offs[i]:offs[i + 1]] for i in range(len(depths))]


class VSSMEncoder(nn.Module):
    """patch_embed + the VSS stages (each but the last merging); returns
    [the input of each stage ..., the normed bottleneck]."""

    def __init__(self, in_chans: int = 3,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.2, scan_impl: str = "auto",
                 use_remat: bool = False, d_state: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(depths)
        stage_dpr = _stage_drop_paths(depths, drop_path_rate)
        self.patch_embed = PatchEmbed2D(PATCH_SIZE, in_chans, dims[0],
                                        device=device, generator=generator)
        self.layers = nn.ModuleList(
            VSSLayer(dims[i], depths[i], stage_dpr[i], downsample=i < n - 1,
                     scan_impl=scan_impl, use_remat=use_remat,
                     d_state=d_state, device=device, generator=generator)
            for i in range(n))
        self.norm = nn.LayerNorm(dims[-1], eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        x = self.patch_embed(x)
        feats = []
        for layer in self.layers:
            feats.append(x)
            x = layer(x)
        feats.append(self.norm(x))
        return feats


class VSSMDecoder(nn.Module):
    """``VSSM``'s decoder, its head split into the 16-channel embedding
    (``emb_conv``) and the 1x1 prediction conv (``out_conv``)."""

    def __init__(self, num_classes: int = 4,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.2, embed_channels: int = 16,
                 scan_impl: str = "auto", use_remat: bool = False,
                 d_state: int = 16, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(depths)
        stage_dpr = _stage_drop_paths(depths, drop_path_rate)
        self.layers_up = nn.ModuleList([PatchExpand2D(
            dims[-1], device=device, generator=generator)])
        self.concat_back_dim = nn.ModuleList()
        for i in range(1, n):
            mirror = n - 1 - i
            self.concat_back_dim.append(linear(
                2 * dims[mirror], dims[mirror], True, device, generator))
            self.layers_up.append(VSSLayer(
                dims[mirror], depths[mirror], stage_dpr[mirror],
                upsample=i < n - 1, scan_impl=scan_impl, use_remat=use_remat,
                d_state=d_state, device=device, generator=generator))
        self.norm_up = nn.LayerNorm(dims[0], eps=1e-5, device=device)
        self.up = FinalPatchExpand2D(dims[0], PATCH_SIZE, device=device,
                                     generator=generator)
        self.emb_conv = nn.Conv2d(dims[0], embed_channels, 3, padding=1,
                                  device=device)
        lecun_normal_(self.emb_conv.weight, generator)
        nn.init.zeros_(self.emb_conv.bias)
        self.out_conv = nn.Conv2d(embed_channels, num_classes, 1, bias=False,
                                  device=device)
        lecun_normal_(self.out_conv.weight, generator)

    def head(self, emb: torch.Tensor) -> torch.Tensor:
        """The 1x1 prediction conv (a pointwise linear) on the
        channels-last embedding, fp32 logits."""
        return F.linear(emb, self.out_conv.weight.flatten(1)).float()

    def forward(self, feats: Sequence[torch.Tensor]):
        n = len(self.layers_up)
        x = self.layers_up[0](feats[-1])
        for i in range(1, n):
            x = torch.cat([x, feats[n - 1 - i]], dim=-1)
            x = self.layers_up[i](self.concat_back_dim[i - 1](x))
        x = self.up(self.norm_up(x))
        emb = self.emb_conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.head(emb), emb


class MambaUnetMask(nn.Module):
    """``patch_size`` (default ``img_size``, whose default 256 is the JAX
    model's ``patch_size``) sizes the position embedding and the mix-out
    head: a position-id or mask input must come from images of that size;
    the clean forward also takes smaller or larger images (the position
    embedding is resized). ``cube_size`` sets the location classes,
    (patch_size // cube_size)²."""

    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 cube_size: int = 32, patch_size: Optional[int] = None,
                 img_size: int = 256,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 d_state: int = 16, drop_path_rate: float = 0.2,
                 embed_channels: int = 16, scan_impl: str = "auto",
                 use_remat: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        patch_size = img_size if patch_size is None else patch_size
        self.cube_size, self.patch_size = cube_size, patch_size
        kw = dict(depths=depths, dims=dims, drop_path_rate=drop_path_rate,
                  scan_impl=scan_impl, use_remat=use_remat, d_state=d_state,
                  device=device, generator=generator)
        self.encoder = VSSMEncoder(3 if in_chans == 1 else in_chans, **kw)
        self.decoder = VSSMDecoder(num_classes, embed_channels=embed_channels,
                                   **kw)
        # a cube's bottleneck with four stages (/32), as JAX's init_all
        # sizes it
        self.fc_layer = FcLayer((cube_size // 32) ** 2 * dims[-1], cube_size,
                                patch_size, ndim=2, device=device,
                                generator=generator)
        self.pos_embed_layer = PosEmbedLayer(cube_size, patch_size,
                                             device=device,
                                             generator=generator)
        self.mix_out_layer = MixOutLayer(patch_size, embed_channels,
                                         device=device, generator=generator)

    def forward_prediction_head(self, emb: torch.Tensor) -> torch.Tensor:
        return self.decoder.head(emb)

    def forward_encoder(self, x: torch.Tensor, pos_embed=None, mask=None
                        ) -> List[torch.Tensor]:
        return self.encoder(self.pos_embed_layer(x, pos_embed, mask))

    def forward_decoder(self, feats: Sequence[torch.Tensor]):
        return self.decoder(feats)

    def forward_location(self, flat: torch.Tensor) -> torch.Tensor:
        return self.fc_layer(flat)

    def forward_mix_pos_mask(self, x: torch.Tensor, pos_embed=None,
                             mask=None) -> torch.Tensor:
        _, emb = self.decoder(self.forward_encoder(x, pos_embed, mask))
        return self.mix_out_layer(emb)

    def forward(self, x: torch.Tensor, pos_embed=None, mask=None):
        return self.decoder(self.forward_encoder(x, pos_embed, mask))
