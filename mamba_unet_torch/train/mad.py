"""MAD: the label denoiser's pretraining and the stacked fine-tuning.

Port of ``mamba_unet_tpu/train/mad.py`` (the reference's
``MAD_Pretrain.py`` and ``MAD_FineTuning.py``).

* :class:`MADPretrainTrainer` is the base fully-supervised step on
  (corrupted near-one-hot label -> clean label) batches
  (``data/mad_augment.py::MADPretrainTransform``); only its validation
  differs: the denoiser sees corrupted label slices, not images
  (``eval/inference.py::test_single_volume_mad``).
* :class:`MADFineTuneTrainer` trains three networks, each under its own
  optimizer and schedule: the segmenter ``seg`` (``model``), the denoiser
  ``mad``, which sees softmax((softmax(seg) + mask_label) / 2) with the
  segmenter's softmax detached, and a second denoiser ``den`` (the
  reference's misnamed ``ema``), which sees softmax(seg) live, so its loss
  backpropagates into the segmenter. The loss is the sum of the three
  models' 0.5 (CE + Dice). The mad Dice is taken on the mad model's own
  output, as in the JAX package (the reference's ``MAD_FineTuning.py:118``
  takes it on the segmenter's softmax). The three train-mode forwards draw
  from the trainer's generator on streams 0, 1 and 2 of the step's seed,
  as the JAX step splits its key into r1, r2, r3.

The fine-tuning is validated stacked, argmax(den(softmax(seg(x))))
(``test_single_volume_stacked``); a new best saves the trio at one step as
``best``/``best2``/``best3`` (seg/mad/den), and the periodic checkpoint
carries the three models, optimizers and schedules.

Both run data parallel as the base step does: over a data axis of S
ranks each rank holds B / S rows of the global batch (its corrupted
labels drawn by every rank's loader for the whole batch), the three
losses' sums are taken over the ranks and the three models' gradients
summed in one all-reduce.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.eval.inference import (
    test_single_volume_mad,
    test_single_volume_stacked,
)
from mamba_unet_torch.objectives import supervised_ce_dice
from mamba_unet_torch.parallel.comm import batch_shard
from mamba_unet_torch.train.methods import _main_head
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    zero_unreached_grads,
)
from mamba_unet_torch.utils.checkpoint import save_checkpoint


def _mean_dice(metrics) -> float:
    return float(np.asarray(metrics)[:, :, 0].mean())


class MADPretrainTrainer(Trainer):
    """The base step on corrupted-label batches; validated on corrupted
    label slices (``transform.mask_label_only`` corrupts each one)."""

    def __init__(self, model: nn.Module, config: TrainConfig,
                 transform=None, **kw):
        self.transform = transform
        super().__init__(model, config, **kw)

    def evaluate(self, val_dataset, model: Optional[nn.Module] = None
                 ) -> float:
        cfg = self.config
        model = self.model if model is None else model
        predict = self.predict_fn(model)
        try:
            return _mean_dice([
                test_single_volume_mad(
                    val_dataset[i]["label"], predict, cfg.num_classes,
                    corrupt_fn=self.transform.mask_label_only,
                    patch_size=cfg.patch_size,
                    batch_size=cfg.eval_batch_size)
                for i in range(len(val_dataset))])
        finally:
            model.train()


class MADFineTuneTrainer(Trainer):
    """The stacked fine-tuning of a segmenter and two denoisers."""

    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 mad_model: nn.Module, den_model: nn.Module, **kw):
        """``mad_model`` and ``den_model`` are two denoisers of one
        architecture, built by the caller with their own initializations
        (the CLI seeds them with ``seed + 1`` and ``seed + 2``); ``kw`` goes
        to :class:`Trainer` (``make_optimizer``, ``device``)."""
        super().__init__(model, config, **kw)
        self.mad_model = self._adopt(mad_model)
        self.den_model = self._adopt(den_model)
        self.mad_optimizer, self.mad_scheduler = self.make_optimizer(
            self.mad_model.parameters())
        self.den_optimizer, self.den_scheduler = self.make_optimizer(
            self.den_model.parameters())

    def _members(self) -> List[Tuple[nn.Module, Any, Any]]:
        return [(self.model, self.optimizer, self.scheduler),
                (self.mad_model, self.mad_optimizer, self.mad_scheduler),
                (self.den_model, self.den_optimizer, self.den_scheduler)]

    def _best_models(self) -> List[Tuple[str, nn.Module]]:
        """One stacked evaluation, one mark (``best``)."""
        return [("best", self.model)]

    def _save_best(self, name: str, model: nn.Module, it: int) -> None:
        """The trio at one step: seg, mad, den as best, best2, best3."""
        for i, (member, _, _) in enumerate(self._members()):
            save_checkpoint(self.config.snapshot_dir, it,
                            member.state_dict(),
                            name=f"{name}{i + 1 if i else ''}")

    def evaluate(self, val_dataset, model: Optional[nn.Module] = None
                 ) -> float:
        """Mean Dice of argmax(den(softmax(seg(x)))) over the val volumes
        and the foreground classes (``model`` is the segmenter, by default
        the trained one)."""
        cfg = self.config
        seg = self.model if model is None else model
        seg_fn, den_fn = self.predict_fn(seg), self.predict_fn(
            self.den_model)
        try:
            return _mean_dice([
                test_single_volume_stacked(
                    v["image"], v["label"], seg_fn, den_fn, cfg.num_classes,
                    patch_size=cfg.patch_size,
                    batch_size=cfg.eval_batch_size)
                for v in (val_dataset[i] for i in range(len(val_dataset)))])
        finally:
            seg.train()
            self.den_model.train()

    def _forward(self, model: nn.Module, x: torch.Tensor, stream: int
                 ) -> torch.Tensor:
        model.train()
        self._reseed(stream)
        return _main_head(model(x))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dev, g = self.device, self.group
        image = batch["image"].to(dev, non_blocking=True).float()
        n = image.shape[0]
        image = self._rows(image, n)
        label = self._rows(batch["label"].to(dev, non_blocking=True).long(),
                           n)
        mask_label = batch.get("mask_label")
        if mask_label is not None:
            mask_label = self._rows(mask_label.to(dev, non_blocking=True), n)
        members = self._members()
        for _, opt, _ in members:
            opt.zero_grad(set_to_none=True)
        with self._autocast(), batch_shard(self._shard_of(n)):
            seg_out = self._forward(self.model, image, 0)
            seg_soft = F.softmax(seg_out.float(), dim=-1)
            # the mad input detaches the segmenter; the den input does not
            blend = seg_soft.detach()
            if mask_label is not None:
                blend = F.softmax((blend + mask_label.float()) / 2.0, dim=-1)
            mad_out = self._forward(self.mad_model, blend, 1)
            den_out = self._forward(self.den_model, seg_soft, 2)
            seg_loss = supervised_ce_dice(seg_out, label, g)
            mad_loss = supervised_ce_dice(mad_out, label, g)
            den_loss = supervised_ce_dice(den_out, label, g)
            total = seg_loss + mad_loss + den_loss
        total.backward()
        zero_unreached_grads(*(m for m, _, _ in members))
        self._reduce_grads(*(m for m, _, _ in members))
        for _, opt, sched in members:
            opt.step()
            sched.step()
        self.step += 1
        return {"loss_total": total.detach(), "loss_seg": seg_loss.detach(),
                "loss_mad": mad_loss.detach(), "loss_den": den_loss.detach(),
                "lr": self.scheduler.get_last_lr()[0]}
