"""Optimizers with a per-iteration learning-rate schedule.

Port of ``mamba_unet_tpu/train/optim.py``. Each builder returns
``(optimizer, scheduler)``: the trainer calls ``optimizer.step()`` and then
``scheduler.step()`` once per iteration, so update k (counting from 0) uses
the schedule's value at k, as optax's ``scale_by_learning_rate`` does:

* :func:`poly_sgd` - SGD, momentum 0.9, weight decay 1e-4 on every parameter
  (added to the gradient before the momentum buffer), no Nesterov, with
  lr_k = base_lr * (1 - k / max_iters) ** 0.9. This is the optax chain
  ``add_decayed_weights -> trace -> scale_by_learning_rate(poly_lr)``.
* :func:`warmup_adamw` - AdamW (decoupled weight decay 0.05 on every
  parameter) with a linear warm-up from 0 over ``warmup_iters``, then the
  poly decay over the remaining iterations, as ``optax.adamw`` on
  ``join_schedules([linear_schedule, poly_lr])``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

Schedule = Callable[[int], float]


def poly_lr(base_lr: float, max_iters: int, power: float = 0.9) -> Schedule:
    """k -> base_lr * (1 - k / max_iters) ** power (0 from max_iters on)."""
    def schedule(count: int) -> float:
        return base_lr * max(0.0, 1.0 - count / max_iters) ** power

    return schedule


def _scheduled(optimizer: torch.optim.Optimizer, base_lr: float,
               schedule: Schedule) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    if base_lr == 0:
        raise ValueError("base_lr must be non-zero (the schedule is a factor "
                         "of it)")
    return optimizer, LambdaLR(optimizer, lambda k: schedule(k) / base_lr)


def poly_sgd(params: Iterable[torch.Tensor], base_lr: float = 0.01,
             max_iters: int = 10_000, momentum: float = 0.9,
             weight_decay: float = 1e-4, power: float = 0.9
             ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    opt = torch.optim.SGD(params, lr=base_lr, momentum=momentum,
                          weight_decay=weight_decay, nesterov=False)
    return _scheduled(opt, base_lr, poly_lr(base_lr, max_iters, power))


def warmup_adamw(params: Iterable[torch.Tensor], base_lr: float = 1e-3,
                 max_iters: int = 10_000, weight_decay: float = 0.05,
                 warmup_iters: int = 250, power: float = 0.9
                 ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    """AdamW + linear warm-up + poly decay, for training from scratch."""
    decay = poly_lr(base_lr, max(max_iters - warmup_iters, 1), power)

    def schedule(count: int) -> float:
        if count < warmup_iters:
            return base_lr * count / warmup_iters
        return decay(count - warmup_iters)

    opt = torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return _scheduled(opt, base_lr, schedule)
