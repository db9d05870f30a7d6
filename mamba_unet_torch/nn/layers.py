"""Shared initializers, ``DropPath``, ``Dropout``, ``BatchNorm1d``,
``BatchNorm2d``, ``BatchNorm3d`` and ``GroupNorm``.

Port of ``mamba_unet_tpu/nn/layers.py``, plus flax's ``nn.Dropout``,
``nn.BatchNorm`` and ``nn.GroupNorm`` as the UNet family, Swin-UNet and the
VNet family use them. Initializers
draw on the CPU from an explicit ``torch.Generator`` and copy into the
parameter, so one seed gives the same weights on every device. Every
module that draws in training (:class:`Drawing`: ``DropPath``, ``Dropout``
and the UNet family's feature perturbations) draws from a generator its
owner (the trainer) hands it with :func:`set_generator`, never from the
global one. Under a data-parallel step (``parallel.comm.batch_shard``)
the dropout and drop-path masks are drawn for the global batch and the
BatchNorms normalize with the global batch's statistics, so the ranks
compute what one process computes on the whole batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.parallel.comm import all_reduce, current_batch_shard


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or unchanged when it is fp64: the fp32 islands
    (normalization statistics, logits, losses) widen lower precisions and
    leave an fp64 model fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


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


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """flax's ``nn.leaky_relu``: where(x >= 0, x, slope x), whose gradient
    at exactly 0 is 1 (``F.leaky_relu``'s is the slope). Exact zeros occur
    where a train-mode BatchNorm normalizes equal rows (the mask heads'
    identity position ids)."""
    return torch.where(x >= 0, x, x * negative_slope)


class Drawing(nn.Module):
    """A module that draws random numbers in training, from
    ``self.generator``: a ``torch.Generator`` on the input's device that
    :func:`set_generator` sets. There is no default."""

    def __init__(self):
        super().__init__()
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__} in training needs a "
                               f"generator: set_generator(model, generator)")
        return self.generator


class DropPath(Drawing):
    """Per-sample stochastic depth: drops the whole residual branch with
    probability ``rate`` in training and rescales by 1/keep. Identity in
    eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The per-sample keep mask for ``x`` from ``self.generator``, or
        None where this is the identity (rate 0 or eval mode)."""
        if self.rate == 0.0 or not self.training:
            return None
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return _global_rand(shape, x.device, self._generator()
                            ) < 1.0 - self.rate

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``, from :meth:`draw`, is applied instead of a new draw: a
        recomputed forward (activation checkpointing) must drop what the
        first one dropped."""
        if mask is None:
            mask = self.draw(x)
        if mask is None:
            return x
        keep = 1.0 - self.rate
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _global_rand(shape, device, generator: torch.Generator) -> torch.Tensor:
    """``torch.rand(shape)`` for a batch (first axis) that is this rank's
    rows of a global batch (``parallel.comm.batch_shard``): the draw is
    made for the global batch and this rank's rows are kept, so the ranks
    of a data-parallel step drop what one process would drop."""
    shard = current_batch_shard()
    if shard is None:
        return torch.rand(shape, device=device, generator=generator)
    full = (shape[0] * shard.count,) + tuple(shape[1:])
    return shard.rows(torch.rand(full, device=device, generator=generator))


def _batch_mean(x: torch.Tensor, dims, shard) -> torch.Tensor:
    """The mean of ``x`` over ``dims`` and the global batch whose rows
    ``shard`` holds, its sum taken over the shard's group
    (differentiable); with no ``shard``, over this batch."""
    count, group = (1, None) if shard is None else (shard.count, shard.group)
    for d in dims:
        count *= x.shape[d]
    return all_reduce(x.sum(dims), group) / count


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Elementwise dropout: keep with probability 1 - ``rate`` and rescale
    by 1/keep (flax ``nn.Dropout``)."""
    keep = 1.0 - rate
    mask = _global_rand(x.shape, x.device, generator) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(Drawing):
    """flax ``nn.Dropout(rate)`` in training, the identity in eval mode or
    at rate 0; its mask comes from ``self.generator``
    (``torch.nn.Dropout`` draws from the global generator)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return dropout(x, self.rate, self._generator())


class _FlaxBatchNorm:
    """The training forward of flax ``nn.BatchNorm`` on (B, C, *spatial),
    mixed into a torch BatchNorm class: epsilon 1e-5 and momentum 0.99
    (torch's 0.01). In training it normalizes with the batch statistics and
    averages the *biased* batch variance into ``running_var``, as flax
    does (torch's BatchNorm averages the unbiased one); in eval mode it
    normalizes with the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        shard = current_batch_shard()
        if shard is not None:
            return self._global_forward(x, shard)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.float(), dim=(0, *range(2, x.dim())), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _global_forward(self, x: torch.Tensor, shard) -> torch.Tensor:
        """Training forward on this rank's rows of a global batch: the
        statistics of the global batch, its sums taken over the shard's
        group, the variance in two passes (the mean, then the mean square
        deviation), as ``F.batch_norm`` computes it in one process."""
        xf = at_least_fp32(x)
        dims = (0, *range(2, x.dim()))
        view = (1, -1) + (1,) * (x.dim() - 2)
        mean = _batch_mean(xf, dims, shard)
        var = _batch_mean((xf - mean.reshape(view)) ** 2, dims, shard)
        y = ((xf - mean.reshape(view)) * (torch.rsqrt(var + self.eps)
                                          * self.weight).reshape(view)
             + self.bias.reshape(view))
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` on (B, C, H, W) (:class:`_FlaxBatchNorm`)."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01,
                         device=device)


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """flax ``nn.BatchNorm`` on (B, C, D, H, W) (:class:`_FlaxBatchNorm`)."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01,
                         device=device)


class BatchNorm1d(nn.BatchNorm1d):
    """flax ``nn.BatchNorm`` on (B, C) features (after a ``Dense``), as
    :class:`BatchNorm2d`, but normalizing in training with flax's own
    arithmetic in fp32 (fp64 for an fp64 input): var = mean(x²) - mean(x)² (flax's fast variance,
    floored at 0), y = (x - mean) * rsqrt(var + eps) * scale + bias. At a
    batch of a few rows a feature's variance can be of the order of eps,
    where y follows every rounding of var; and rows that are all equal
    (the position embedding's identity ids, the same for every sample)
    normalize to exactly 0, where ``F.batch_norm`` leaves ~1e-5 of noise
    that the layers after it amplify."""

    def __init__(self, num_features: int, *, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.01,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = at_least_fp32(x)
        shard = current_batch_shard()
        mean = _batch_mean(xf, (0,), shard)
        ex2 = _batch_mean(xf * xf, (0,), shard)
        var = (ex2 - mean * mean).clamp_min(0.0)
        y = ((xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
             + self.bias)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on (B, C, *spatial), with flax's defaults:
    epsilon 1e-6, a per-channel scale and bias, and the fast variance
    E[x²] - E[x]² (floored at 0) over each group's channels and voxels.
    The statistics and the normalization run in fp32 whatever the input's
    dtype (also under autocast; fp64 for an fp64 input); the output takes
    the input's dtype.
    ``group_size=1`` is flax's instance norm (the VNet family's
    ``instancenorm``), ``num_groups=16`` its ``groupnorm``. torch's
    ``F.group_norm`` differs: epsilon 1e-5 and a two-pass variance."""

    def __init__(self, num_channels: int, num_groups: Optional[int] = None,
                 group_size: Optional[int] = None, eps: float = 1e-6, *,
                 device=None):
        super().__init__()
        if (num_groups is None) == (group_size is None):
            raise ValueError("give one of num_groups and group_size")
        if group_size is not None:
            num_groups = num_channels // group_size
        if num_groups <= 0 or num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = at_least_fp32(x).reshape(b, self.num_groups,
                                      c // self.num_groups, -1)
        mean = xf.mean((2, 3), keepdim=True)
        var = ((xf * xf).mean((2, 3), keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * at_least_fp32(
            self.weight).reshape(1, self.num_groups, -1, 1)
        y = (xf - mean) * mul + at_least_fp32(self.bias).reshape(
            1, self.num_groups, -1, 1)
        return y.reshape(x.shape).to(x.dtype)


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> int:
    """Hand ``generator`` to every :class:`Drawing` module in ``model``;
    returns how many there are."""
    drawing = [m for m in model.modules() if isinstance(m, Drawing)]
    for m in drawing:
        m.generator = generator
    return len(drawing)
