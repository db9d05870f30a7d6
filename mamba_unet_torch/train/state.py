"""The EMA teacher's update.

Port of ``ema_update`` from ``mamba_unet_tpu/train/state.py``. The port's
``TrainState`` is the trainer itself (model, optimizer, scheduler, step);
what the JAX state adds for the EMA-teacher methods is ``ema_params``, here
a dict of the model's parameter names to detached tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], step: int,
               alpha: float = 0.99) -> float:
    """ema = a * ema + (1 - a) * param for every entry of ``ema``, in
    place, with a = min(1 - 1 / (step + 1), alpha); returns a. The methods
    pass the step count after the optimizer's update (the JAX state's
    ``step`` after ``apply_gradients``), so the first update averages with
    a = 0.5. Parameters only: buffers are not averaged."""
    a = min(1.0 - 1.0 / (step + 1.0), alpha)
    names = list(ema)
    mine = [ema[n] for n in names]
    torch._foreach_mul_(mine, a)
    torch._foreach_add_(mine, [params[n].detach() for n in names],
                        alpha=1.0 - a)
    return a
