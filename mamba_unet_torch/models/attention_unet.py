"""The 3-D attention U-Net: grid attention gates on the skips and deep
supervision.

Port of ``mamba_unet_tpu/models/attention_unet.py`` (the reference's
``attention_unet.py`` and ``grid_attention_layer.py``, 'concatenation'
mode): the 3-D UNet's encoder (filters (64, ..., 1024) /
``feature_scale``), a gating signal (1^3 conv, BatchNorm, ReLU) from the
centre block, attention on skips 2-4 (theta = 2^3/2 conv of the skip, phi
= 1^3 conv of the gate resized to theta's grid, psi = 1^3 conv -> sigmoid,
resized to the skip, times the skip, then 1^3 conv + BatchNorm, a 1^3
combine conv + BatchNorm + ReLU), the trilinear up blocks, and 1^3 heads
at every decoder scale, resized to the input and concatenated into the
final 1^3 conv.

Volumes come in channels-last, (B, D, H, W, C), and logits go out as fp32
channels-last. The resizes are ``jax.image.resize``'s trilinear one
(``models/unet_3d.py::resize``). Module names are the flax module's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.models.segmamba import check_rank
from mamba_unet_torch.models.unet_3d import UnetConv3, UnetUp3CT, resize
from mamba_unet_torch.models.vnet import channels_first, channels_last, conv
from mamba_unet_torch.nn.layers import BatchNorm3d


class GridAttentionBlock3D(nn.Module):
    def __init__(self, cin: int, gate: int, inter_channels: int,
                 sub_sample: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.theta = conv(3, cin, inter_channels, sub_sample,
                          stride=sub_sample, bias=False, **kw)
        self.phi = conv(3, gate, inter_channels, 1, **kw)
        self.psi = conv(3, inter_channels, 1, 1, **kw)
        self.W = conv(3, cin, cin, 1, **kw)
        self.BatchNorm_0 = BatchNorm3d(cin, device=device)

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        """x: the skip (B, C, D, H, W); g: the gate (B, Cg, d, h, w)."""
        theta = self.theta(x)
        phi = resize(self.phi(g), theta.shape[2:])
        att = torch.sigmoid(self.psi(F.relu(theta + phi)))
        att = resize(att, x.shape[2:])
        return self.BatchNorm_0(self.W(att * x)), att


class MultiAttentionBlock(nn.Module):
    def __init__(self, cin: int, gate: int, inter_channels: int, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.gate_1 = GridAttentionBlock3D(cin, gate, inter_channels, **kw)
        self.combine = conv(3, cin, cin, 1, **kw)
        self.BatchNorm_0 = BatchNorm3d(cin, device=device)

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        y, att = self.gate_1(x, g)
        return F.relu(self.BatchNorm_0(self.combine(y))), att


class AttentionUNet3D(nn.Module):
    def __init__(self, num_classes: int = 2, in_chans: int = 1,
                 feature_scale: int = 4, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = [int(v / feature_scale) for v in (64, 128, 256, 512, 1024)]
        kw = dict(device=device, generator=generator)
        cin = in_chans
        for i in range(4):
            self.add_module(f"conv{i + 1}", UnetConv3(cin, f[i], **kw))
            cin = f[i]
        self.center = UnetConv3(f[3], f[4], **kw)
        self.gating = conv(3, f[4], f[4], 1, **kw)
        self.BatchNorm_0 = BatchNorm3d(f[4], device=device)
        self.attn4 = MultiAttentionBlock(f[3], f[4], f[3], **kw)
        self.up_concat4 = UnetUp3CT(f[4], f[3], f[3], **kw)
        self.attn3 = MultiAttentionBlock(f[2], f[3], f[2], **kw)
        self.up_concat3 = UnetUp3CT(f[3], f[2], f[2], **kw)
        self.attn2 = MultiAttentionBlock(f[1], f[2], f[1], **kw)
        self.up_concat2 = UnetUp3CT(f[2], f[1], f[1], **kw)
        self.up_concat1 = UnetUp3CT(f[1], f[0], f[0], **kw)
        for k in (4, 3, 2, 1):
            self.add_module(f"dsv{k}", conv(3, f[k - 1], num_classes, 1,
                                            **kw))
        self.final = conv(3, 4 * num_classes, num_classes, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 3, "AttentionUNet3D")
        full = x.shape[1:4]
        x = channels_first(x)
        skips = []
        for i in range(4):
            x = getattr(self, f"conv{i + 1}")(x)
            skips.append(x)
            x = F.max_pool3d(x, 2)
        center = self.center(x)
        gating = F.relu(self.BatchNorm_0(self.gating(center)))
        g4, _ = self.attn4(skips[3], gating)
        up4 = self.up_concat4(g4, center)
        g3, _ = self.attn3(skips[2], up4)
        up3 = self.up_concat3(g3, up4)
        g2, _ = self.attn2(skips[1], up3)
        up2 = self.up_concat2(g2, up3)
        up1 = self.up_concat1(skips[0], up2)
        dsv = [self.dsv1(up1)] + [
            resize(getattr(self, f"dsv{k}")(up), full)
            for k, up in ((2, up2), (3, up3), (4, up4))]
        out = self.final(torch.cat(dsv, dim=1))
        return channels_last(out).float()
