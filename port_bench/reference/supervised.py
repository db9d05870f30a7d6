"""Fully supervised training (Mamba-UNet's ``train_fully_supervised_2D``):
the loss is 0.5 (CE + Dice) on the whole batch. Drop path is drawn per
block in forward order from a generator seeded per step with the
trainer's documented recipe (``train.step_seed`` of (seed, step))."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.net import Net, family
from port_bench.reference.precision import Precision
from port_bench.reference.train import (
    checkpointed_scan,
    cross_entropy,
    dice,
    follow_sgd,
    step_seed,
)


def loss(cfg: dict, traffic: dict, P: Dict[str, torch.Tensor], batch,
         scan: Callable, prec: Optional[Precision] = None,
         gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step's loss; ``gen`` draws the drop-path masks (None: none)."""
    net = Net(P, cfg, prec, scan, gen)
    logits = family(cfg).forward(net, batch["image"]).float()
    return 0.5 * (cross_entropy(logits, batch["label"])
                  + dice(F.softmax(logits, -1), batch["label"]))


def follow(cfg: dict, traffic: dict, P0: Dict[str, torch.Tensor],
           batches: List[Dict[str, torch.Tensor]], seed: int,
           prec: Optional[Precision] = None,
           scan: Callable = checkpointed_scan) -> Dict[str, object]:
    """The readings of ``train.follow_sgd`` over ``batches``."""

    def step_loss(P, batch, k):
        gen = torch.Generator(device=batch["image"].device)
        gen.manual_seed(step_seed(seed, k))
        return loss(cfg, traffic, P, batch, scan, prec, gen)

    return follow_sgd(cfg, traffic, P0, batches, step_loss)
