"""Shared initializers and ``DropPath``.

Port of ``mamba_unet_tpu/nn/layers.py``. Initializers draw on the CPU from
an explicit ``torch.Generator`` and copy into the parameter, so one seed
gives the same weights on every device. ``DropPath`` draws its masks from
a generator its owner (the trainer) hands it with
:func:`set_drop_path_generator`, never from the global one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def _fill(param: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return param.copy_(values)


def trunc_normal_(param: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std: the default for Linear weights."""
    t = torch.empty(param.shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return _fill(param, t)


def lecun_normal_(param: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated normal with variance 1/fan_in (flax ``nn.Conv``'s default).

    ``param`` is a torch conv weight (out, in/groups, kh, kw)."""
    fan_in = param[0].numel()
    # 0.8796...: std of a unit normal truncated at +-2
    return trunc_normal_(param, math.sqrt(1.0 / fan_in) / 0.87962566103423978,
                         generator)


def uniform_(param: torch.Tensor, bound: float,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform(-bound, bound)."""
    t = torch.empty(param.shape).uniform_(-bound, bound, generator=generator)
    return _fill(param, t)


def linear(in_features: int, out_features: int, bias: bool, device,
           generator: Optional[torch.Generator]) -> nn.Linear:
    """``nn.Linear`` with a trunc-normal(.02) weight and a zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias, device=device)
    trunc_normal_(layer.weight, generator=generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class DropPath(nn.Module):
    """Per-sample stochastic depth: drops the whole residual branch with
    probability ``rate`` in training and rescales by 1/keep. Identity in
    eval mode. In training the mask comes from ``self.generator``, a
    ``torch.Generator`` on the input's device that
    :func:`set_drop_path_generator` sets; there is no default."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in training needs a generator: "
                               "set_drop_path_generator(model, generator)")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device,
                          generator=self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_drop_path_generator(model: nn.Module,
                            generator: Optional[torch.Generator]) -> int:
    """Hand ``generator`` to every ``DropPath`` in ``model``; returns how
    many there are."""
    paths = [m for m in model.modules() if isinstance(m, DropPath)]
    for m in paths:
        m.generator = generator
    return len(paths)
