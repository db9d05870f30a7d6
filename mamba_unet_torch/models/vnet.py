"""MagicNet's cube-location classifier.

Port of ``FcLayer`` from ``mamba_unet_tpu/models/vnet.py``; the VNet
family of that module is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import BatchNorm1d, lecun_normal_


def dense(in_features: int, out_features: int, device,
          generator: Optional[torch.Generator]) -> nn.Linear:
    """flax ``nn.Dense``: lecun-normal weight, zero bias."""
    layer = nn.Linear(in_features, out_features, device=device)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


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
        x = F.leaky_relu(self.bn(self.fc1(x)), 0.2)
        return self.fc2(x).float()
