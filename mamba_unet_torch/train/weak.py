"""Weak-Mamba-UNet: scribble-supervised multi-view cross-teaching.

Port of ``mamba_unet_tpu/train/weak.py``. Three networks (the CLI's
default trio is a CNN ``unet``, a Swin-UNet ``ViT_seg`` and a Mamba-UNet
``ViM_seg``) train on the same scribble-annotated batches, each under its
own optimizer and schedule from the same ``make_optimizer``:

* pCE: each model's cross-entropy over the scribbled pixels only
  (``ignore_index``, by default ``num_classes``: ACDC-scribble's 4);
* the pseudo-label argmax(a p1 + b p2 + c p3) of the three fp32 softmaxes,
  with no gradient, where (a, b, c) ~ Dirichlet(1, 1, 1) is drawn afresh
  each step (:meth:`WeakScribbleTrainer._mix_weights`);
* each model's Dice against that pseudo-label (0 with ``pce_only``, the
  paper's pCE-only ablation);
* one backward of the sum of the three models' pCE + Dice, then three
  optimizer and schedule steps.

The base ``fit`` evaluates the three models every ``eval_every`` steps,
each with its own best checkpoint (``best``, ``best2``, ``best3``), and the
periodic checkpoint carries the three models, optimizers and schedules and
the step. The three train-mode forwards draw from the trainer's generator
on streams 0, 1 and 2 of the step's seed, as the JAX step splits its key
into r1, r2, r3; the mix weights on stream 3 (its r_mix).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import set_generator
from mamba_unet_torch.objectives import (
    cross_entropy_loss,
    dice_loss_from_labels,
)
from mamba_unet_torch.train.methods import _batch, _main_head
from mamba_unet_torch.train.trainer import TrainConfig, Trainer

MIX = 3  # the generator's stream of the mix weights in a step


class WeakScribbleTrainer(Trainer):
    """Three-network scribble-supervised trainer (Weak-Mamba-UNet)."""

    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 model2: nn.Module, model3: nn.Module,
                 ignore_index: Optional[int] = None, pce_only: bool = False,
                 **kw):
        """``model2`` and ``model3`` are built by the caller with their own
        initializations (the CLI seeds them with ``seed + 1`` and ``seed +
        2``); ``kw`` goes to :class:`Trainer` (``make_optimizer``,
        ``device``)."""
        self.ignore_index = (config.num_classes if ignore_index is None
                             else ignore_index)
        self.pce_only = pce_only
        super().__init__(model, config, **kw)
        self.model2 = model2.to(self.device).train()
        self.model3 = model3.to(self.device).train()
        self.optimizer2, self.scheduler2 = self.make_optimizer(
            self.model2.parameters())
        self.optimizer3, self.scheduler3 = self.make_optimizer(
            self.model3.parameters())
        set_generator(self.model2, self.generator)
        set_generator(self.model3, self.generator)

    def _members(self) -> List[Tuple[nn.Module, Any, Any]]:
        return [(self.model, self.optimizer, self.scheduler),
                (self.model2, self.optimizer2, self.scheduler2),
                (self.model3, self.optimizer3, self.scheduler3)]

    def _mix_weights(self) -> torch.Tensor:
        """This step's (a, b, c) ~ Dirichlet(1, 1, 1): three Exp(1) draws
        from the generator's mix stream, normalised to sum 1."""
        self._reseed(MIX)
        e = torch.empty(3, device=self.device).exponential_(
            generator=self.generator)
        return e / e.sum()

    def _pseudo_labels(self, softs: List[torch.Tensor], mix: torch.Tensor
                       ) -> torch.Tensor:
        """argmax(a p1 + b p2 + c p3) over the class axis, no gradient."""
        with torch.no_grad():
            return (mix[0] * softs[0] + mix[1] * softs[1]
                    + mix[2] * softs[2]).argmax(-1)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        image, scribble = _batch(self, batch)
        mix = self._mix_weights()
        members = self._members()
        for _, opt, _ in members:
            opt.zero_grad(set_to_none=True)
        with self._autocast():
            outs = []
            for stream, (model, _, _) in enumerate(members):
                model.train()
                self._reseed(stream)
                outs.append(_main_head(model(image)))
            softs = [F.softmax(o.float(), dim=-1) for o in outs]
            pseudo = self._pseudo_labels(softs, mix)
            pces = [cross_entropy_loss(o, scribble,
                                       ignore_index=self.ignore_index)
                    for o in outs]
            if self.pce_only:
                dices = [torch.zeros((), device=self.device) for _ in softs]
            else:
                dices = [dice_loss_from_labels(s, pseudo) for s in softs]
            per_model = [p + d for p, d in zip(pces, dices)]
            total = per_model[0] + per_model[1] + per_model[2]
        total.backward()
        for _, opt, sched in members:
            opt.step()
            sched.step()
        self.step += 1
        return {"loss_total": total.detach(),
                **{f"loss_model{i}": m.detach()
                   for i, m in enumerate(per_model, start=1)},
                "loss_pce": sum(pces).detach(),
                "loss_pseudo_dice": sum(dices).detach(),
                "lr": self.scheduler.get_last_lr()[0]}
