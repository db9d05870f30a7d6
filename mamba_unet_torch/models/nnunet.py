"""nnU-Net's Generic_UNet in the reference's anisotropic ACDC
configuration.

Port of ``mamba_unet_tpu/models/nnunet.py`` (the reference's
``nnunet.py``: ``Generic_UNet`` and ``initialize_network``): base 16
features, doubled per stage up to 320, 6 pooling stages with the strides
``POOL_KERNELS`` ((1, 2, 2) twice, (2, 2, 2) twice, (1, 2, 2) twice) and
the kernels ``CONV_KERNELS``, 2 x [conv -> instance norm -> leaky ReLU
0.01] per stage with the stride on the stage's first conv, transposed-conv
upsampling (kernel = stride, no bias) with the skip concatenated after it,
and a 1^3 head without bias. Volumes come in channels-last, (B, D, H, W,
C); depth is pooled 4x and the plane 64x, so an input's depth is a
multiple of 4 and its height and width of 64.

The instance norm is flax's ``GroupNorm(group_size=1)`` with epsilon 1e-5
(:class:`~mamba_unet_torch.nn.layers.GroupNorm`), the leaky ReLU flax's
(gradient 1 at 0). Module names are the flax module's (``enc{s}_conv{c}``,
``bottleneck_conv{c}``, ``up{s}``, ``dec{s}_conv{c}``, ``seg_head``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mamba_unet_torch.models.segmamba import check_rank
from mamba_unet_torch.models.vnet import (
    channels_first,
    channels_last,
    conv,
    conv_transpose,
)
from mamba_unet_torch.nn.layers import GroupNorm, leaky_relu

POOL_KERNELS = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2),
                (1, 2, 2))
CONV_KERNELS = ((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3),
                (3, 3, 3), (3, 3, 3))
MAX_FEATURES = 320


class ConvNormLrelu(nn.Module):
    def __init__(self, cin: int, features: int, kernel: Tuple[int, ...],
                 stride: Optional[Tuple[int, ...]] = None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = conv(3, cin, features, kernel,
                           stride=stride or (1,) * len(kernel),
                           padding=tuple(k // 2 for k in kernel),
                           device=device, generator=generator)
        self.GroupNorm_0 = GroupNorm(features, group_size=1, eps=1e-5,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.GroupNorm_0(self.Conv_0(x)), 0.01)


class GenericUNet(nn.Module):
    def __init__(self, num_classes: int = 4, in_chans: int = 1,
                 base_features: int = 16,
                 pool_kernels: Sequence[Tuple[int, ...]] = POOL_KERNELS,
                 conv_kernels: Sequence[Tuple[int, ...]] = CONV_KERNELS,
                 conv_per_stage: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.n_pool = n = len(pool_kernels)
        self.conv_per_stage = conv_per_stage
        feats = [min(base_features * 2 ** i, MAX_FEATURES)
                 for i in range(n + 1)]
        cin = in_chans
        for stage in range(n):
            k = conv_kernels[stage]
            for c in range(conv_per_stage):
                stride = pool_kernels[stage - 1] if stage and not c else None
                self.add_module(f"enc{stage}_conv{c}", ConvNormLrelu(
                    cin, feats[stage], k, stride, **kw))
                cin = feats[stage]
        for c in range(conv_per_stage):
            self.add_module(f"bottleneck_conv{c}", ConvNormLrelu(
                cin, feats[n], conv_kernels[n],
                None if c else pool_kernels[-1], **kw))
            cin = feats[n]
        for stage in reversed(range(n)):
            s = pool_kernels[stage]
            self.add_module(f"up{stage}", conv_transpose(
                3, cin, feats[stage], s, bias=False, **kw))
            cin = 2 * feats[stage]
            for c in range(conv_per_stage):
                self.add_module(f"dec{stage}_conv{c}", ConvNormLrelu(
                    cin, feats[stage], conv_kernels[stage], **kw))
                cin = feats[stage]
        self.seg_head = conv(3, cin, num_classes, 1, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_rank(x, 3, "GenericUNet")
        x = channels_first(x)
        skips = []
        for stage in range(self.n_pool):
            for c in range(self.conv_per_stage):
                x = getattr(self, f"enc{stage}_conv{c}")(x)
            skips.append(x)
        for c in range(self.conv_per_stage):
            x = getattr(self, f"bottleneck_conv{c}")(x)
        for stage in reversed(range(self.n_pool)):
            x = torch.cat([getattr(self, f"up{stage}")(x), skips[stage]],
                          dim=1)
            for c in range(self.conv_per_stage):
                x = getattr(self, f"dec{stage}_conv{c}")(x)
        return channels_last(self.seg_head(x)).float()
