"""Semi-supervised training methods: mean teacher, UAMT, cross-teaching.

Port of ``mamba_unet_tpu/train/methods.py``. Each is a :class:`Trainer`
with its own step and the same loss composition:

* ``MeanTeacherTrainer``: 0.5 * (CE + Dice) on the labeled part; the MSE
  between the student's and the EMA teacher's softmax (the teacher sees
  the unlabeled part with clip(0.1 N(0, 1), +-0.2) noise) on the
  unlabeled part, gated off before ``warmup_iters``, weighted by
  :func:`rampup_weight`; EMA decay min(1 - 1/(t + 1), 0.99).
* ``UAMTTrainer``: 1 + T = 9 noised teacher passes; the mean softmax of
  the last T gives the predictive entropy, and the consistency counts
  where it is under (0.75 + 0.25 * ramp) * ln 2:
  sum(mask * mse) / (2 * sum(mask) + 1e-16).
* ``CrossTeachingTrainer`` (Semi-Mamba-UNet): two models; each gets the
  supervised term, the ramped Dice against the *other* model's argmax on
  the unlabeled part, and half the contrastive ``constra_loss``; one
  backward of the sum, an optimizer each.

A batch is ``labeled_bs`` labeled samples, then unlabeled ones
(``data.sampler.TwoStreamBatchSampler``).

A teacher forward runs the student module under ``torch.no_grad()`` in
train mode with the EMA parameters in place of its own
(``torch.func.functional_call``), as the JAX teacher is the student's
``apply`` on ``ema_params`` with ``deterministic=False`` under
``stop_gradient``: dropout and drop-path stay on, BatchNorm normalizes with
the batch's statistics, and its running-statistics update goes to copies
that are thrown away. With ``ViM_seg`` it runs the serving scan kernel.

Every draw comes from the trainer's generator, reseeded per step and
stream as the JAX step splits its key: the student's dropout (stream 0),
the teacher's (1, the same for each of UAMT's passes, as JAX reuses one
key) and the teacher noise (2); model 2 of cross-teaching draws from
stream 1.

Over a data axis of S ranks (:class:`Trainer`'s ``mesh``) each rank holds
labeled_bs / S labeled and (B - labeled_bs) / S unlabeled rows of the
global batch (both counts must split over S), draws the teacher noise
for the whole unlabeled batch and keeps its rows, and takes every loss
term's sums over the ranks: the step computes the one-process step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mamba_unet_torch.objectives import (
    batch_mean,
    constra_loss,
    dice_loss_from_labels,
    softmax_mse_loss,
    supervised_ce_dice,
)
from mamba_unet_torch.parallel.comm import all_reduce, batch_shard
from mamba_unet_torch.train.state import ema_update
from mamba_unet_torch.train.trainer import TrainConfig, Trainer

STUDENT, TEACHER, NOISE = 0, 1, 2  # the generator's streams in a step


def rampup_weight(step: int, consistency: float = 0.1,
                  rampup: float = 200.0) -> float:
    """consistency * sigmoid_rampup(step // 150, rampup)."""
    t = min(max((step // 150) / rampup, 0.0), 1.0)
    return consistency * math.exp(-5.0 * (1.0 - t) ** 2)


def _main_head(logits):
    return logits[0] if isinstance(logits, (tuple, list)) else logits


def _batch(trainer: Trainer, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = trainer.device
    return (batch["image"].to(dev, non_blocking=True).float(),
            batch["label"].to(dev, non_blocking=True).long())


class MeanTeacherTrainer(Trainer):
    # gradient accumulation is stratified: each microbatch keeps the
    # labeled:unlabeled ratio, the teacher noise is drawn once for the whole
    # unlabeled batch and sliced, and one EMA update follows the one
    # optimizer update; the Dice term becomes per-microbatch Dice
    supports_grad_accum = True

    def __init__(self, model: nn.Module, config: TrainConfig,
                 labeled_bs: int = 8, consistency: float = 0.1,
                 consistency_rampup: float = 200.0, warmup_iters: int = 1000,
                 **kw):
        self.labeled_bs = labeled_bs
        self.consistency = consistency
        self.consistency_rampup = consistency_rampup
        self.warmup_iters = warmup_iters
        k = config.grad_accum_steps
        if k > 1 and (labeled_bs % k or (config.batch_size - labeled_bs) % k):
            raise ValueError(
                f"labeled_bs={labeled_bs} and unlabeled "
                f"{config.batch_size - labeled_bs} must both be divisible by "
                f"grad_accum_steps={k} (stratified microbatches)")
        super().__init__(model, config, **kw)
        self.ema = {n: p.detach().clone()
                    for n, p in self.model.named_parameters()}

    def _blocks(self):
        """A microbatch's labeled rows, then its unlabeled ones."""
        k = self.config.grad_accum_steps
        return (self.labeled_bs // k,
                (self.config.batch_size - self.labeled_bs) // k)

    def _teacher_inputs(self, unlabeled: torch.Tensor) -> torch.Tensor:
        """The teacher's view: unlabeled + clip(0.1 N(0, 1), +-0.2), drawn
        from the trainer's generator."""
        noise = torch.randn(unlabeled.shape, device=unlabeled.device,
                            generator=self.generator)
        return unlabeled + (0.1 * noise).clamp(-0.2, 0.2)

    def _teacher(self, x: torch.Tensor, rows: int, *substream: int
                 ) -> torch.Tensor:
        """The EMA teacher's main-head logits for ``x``, this rank's rows
        of a global batch of ``rows`` unlabeled samples: no grad, train
        mode, the teacher's stream of the step's seed."""
        self._reseed(TEACHER, *substream)
        buffers = {n: b.clone() for n, b in self.model.named_buffers()}
        with torch.no_grad(), batch_shard(self._shard_of(rows)):
            return _main_head(functional_call(self.model,
                                              (self.ema, buffers), (x,)))

    def _loss(self, image, label, ema_logits, n_labeled):
        """(total, logs) of one (micro)batch: ``image`` is ``n_labeled``
        labeled samples then unlabeled ones (this rank's), ``ema_logits``
        the teacher's logits of the unlabeled ones."""
        g = self.group
        logits = _main_head(self.model(image))
        sup = supervised_ce_dice(logits[:n_labeled], label, g)
        if self.step < self.warmup_iters:
            cons = torch.zeros((), device=logits.device)
        else:
            cons = batch_mean(softmax_mse_loss(logits[n_labeled:],
                                               ema_logits), g)
        w = rampup_weight(self.step, self.consistency,
                          self.consistency_rampup)
        total = sup + w * cons
        return total, {"loss_total": total.detach(),
                       "loss_sup": sup.detach(), "loss_cons": cons.detach()}

    def _finish_step(self, logs: List[Dict[str, torch.Tensor]]
                     ) -> Dict[str, Any]:
        """Optimizer and schedule, the step count, the EMA update; the
        microbatches' logs averaged."""
        w = rampup_weight(self.step, self.consistency,
                          self.consistency_rampup)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        ema_update(self.ema, dict(self.model.named_parameters()), self.step)
        out = {k: torch.stack([d[k] for d in logs]).mean() for k in logs[0]}
        return {**out, "cons_weight": w,
                "lr": self.scheduler.get_last_lr()[0]}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        lb, k = self.labeled_bs, self.config.grad_accum_steps
        self.model.train()
        image, label = _batch(self, batch)
        unlabeled = image[lb:]
        self._reseed(NOISE)
        # noise for the whole unlabeled batch, sliced per microbatch
        ema_in = self._teacher_inputs(unlabeled)
        mlb, mu = lb // k, unlabeled.shape[0] // k
        self.optimizer.zero_grad(set_to_none=True)
        logs = []
        for i in range(k):
            lab, unl = slice(i * mlb, (i + 1) * mlb), slice(i * mu,
                                                            (i + 1) * mu)
            x_lab, y_lab = (self._rows(t[lab], mlb) for t in (image, label))
            x_unl = self._rows(unlabeled[unl], mu)
            with self._autocast():
                ema_logits = self._teacher(self._rows(ema_in[unl], mu), mu,
                                           i)
                self._reseed(STUDENT, i)
                with batch_shard(self._shard_of(mlb, mu)):
                    total, mb_logs = self._loss(torch.cat([x_lab, x_unl]),
                                                y_lab, ema_logits,
                                                x_lab.shape[0])
            (total / k).backward()
            logs.append(mb_logs)
        self._reduce_grads(self.model)
        return self._finish_step(logs)

    def _periodic_tree(self) -> Dict[str, Any]:
        return {**super()._periodic_tree(), "ema": self.ema}

    def _load_periodic(self, tree: Dict[str, Any]) -> None:
        super()._load_periodic(tree)
        for n, t in self.ema.items():
            t.copy_(tree["ema"][n])


class UAMTTrainer(MeanTeacherTrainer):
    """Uncertainty-aware mean teacher: entropy-masked consistency, T = 8."""

    supports_grad_accum = False
    T: int = 8

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        lb, cfg, g = self.labeled_bs, self.config, self.group
        self.model.train()
        image, label = _batch(self, batch)
        nu = image.shape[0] - lb
        self._reseed(NOISE)
        views = [self._rows(self._teacher_inputs(image[lb:]), nu)
                 for _ in range(self.T)]
        with self._autocast():
            # the consistency target sees the first MC pass's noise
            ema_logits = self._teacher(views[0], nu)
            preds = sum(F.softmax(self._teacher(v, nu).float(), dim=-1)
                        for v in views) / self.T
        uncertainty = -(preds * torch.log(preds + 1e-6)).sum(-1,
                                                             keepdim=True)
        ramp = math.exp(-5.0 * (1.0 - min(max(
            self.step / cfg.max_iterations, 0.0), 1.0)) ** 2)
        mask = (uncertainty < (0.75 + 0.25 * ramp) * math.log(2.0)).float()
        self.optimizer.zero_grad(set_to_none=True)
        self._reseed(STUDENT)
        x, y = self._rows(image, lb, nu), self._rows(label[:lb], lb)
        llb = self._local(lb)
        with self._autocast(), batch_shard(self._shard_of(lb, nu)):
            logits = _main_head(self.model(x))
            sup = supervised_ce_dice(logits[:llb], y, g)
            dist = softmax_mse_loss(logits[llb:], ema_logits)
            # both sums over the global unlabeled batch
            masked, kept = all_reduce(torch.stack(
                [(mask * dist).sum(), mask.sum()]), g)
            cons = masked / (2.0 * kept + 1e-16)
            total = sup + rampup_weight(self.step, self.consistency,
                                        self.consistency_rampup) * cons
        total.backward()
        self._reduce_grads(self.model)
        return self._finish_step([{"loss_total": total.detach(),
                                   "loss_sup": sup.detach(),
                                   "loss_cons": cons.detach()}])


class CrossTeachingTrainer(Trainer):
    """Semi-Mamba-UNet: two networks teach each other, plus the contrastive
    term. Both are evaluated every ``eval_every`` with their own best
    checkpoints (``best``, ``best2``), and the periodic checkpoint carries
    both models, both optimizers and schedules, and the step."""

    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 model2: nn.Module, labeled_bs: int = 8,
                 consistency: float = 0.1, consistency_rampup: float = 200.0,
                 **kw):
        """``model2`` is built by the caller with its own initialization
        (the CLI seeds it with ``seed + 1``); it trains under an optimizer
        of the same kind, from the same ``make_optimizer``."""
        self.labeled_bs = labeled_bs
        self.consistency = consistency
        self.consistency_rampup = consistency_rampup
        super().__init__(model, config, **kw)
        self.model2 = self._adopt(model2)
        self.optimizer2, self.scheduler2 = self.make_optimizer(
            self.model2.parameters())

    def _blocks(self):
        return (self.labeled_bs, self.config.batch_size - self.labeled_bs)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        lb, g = self.labeled_bs, self.group
        self.model.train()
        self.model2.train()
        image, label = _batch(self, batch)
        blocks = (lb, image.shape[0] - lb)
        image, label = self._rows(image, *blocks), self._rows(label[:lb], lb)
        lb = self._local(lb)
        self.optimizer.zero_grad(set_to_none=True)
        self.optimizer2.zero_grad(set_to_none=True)
        with self._autocast(), batch_shard(self._shard_of(*blocks)):
            self._reseed(STUDENT)
            out1 = _main_head(self.model(image))
            self._reseed(TEACHER)
            out2 = _main_head(self.model2(image))
            soft1 = F.softmax(out1.float(), dim=-1)
            soft2 = F.softmax(out2.float(), dim=-1)
            sup1 = supervised_ce_dice(out1[:lb], label, g)
            sup2 = supervised_ce_dice(out2[:lb], label, g)
            pseudo1 = soft1[lb:].detach().argmax(-1)
            pseudo2 = soft2[lb:].detach().argmax(-1)
            ps1 = dice_loss_from_labels(soft1[lb:], pseudo2, group=g)
            ps2 = dice_loss_from_labels(soft2[lb:], pseudo1, group=g)
            con = constra_loss(out1, out2, g)
            w = rampup_weight(self.step, self.consistency,
                              self.consistency_rampup)
            m1 = sup1 + w * ps1 + 0.5 * con
            m2 = sup2 + w * ps2 + 0.5 * con
            total = m1 + m2
        total.backward()
        self._reduce_grads(self.model, self.model2)
        for opt, sched in ((self.optimizer, self.scheduler),
                           (self.optimizer2, self.scheduler2)):
            opt.step()
            sched.step()
        self.step += 1
        return {"loss_total": total.detach(), "loss_model1": m1.detach(),
                "loss_model2": m2.detach(), "loss_constra": con.detach(),
                "cons_weight": w, "lr": self.scheduler.get_last_lr()[0]}

    def evaluate2(self, val_dataset) -> float:
        """Model 2's mean val Dice."""
        return self.evaluate(val_dataset, model=self.model2)

    def _members(self):
        return [(self.model, self.optimizer, self.scheduler),
                (self.model2, self.optimizer2, self.scheduler2)]


def build_semi_method(args, model: nn.Module, cfg: TrainConfig,
                      model2: Optional[nn.Module] = None, **kw) -> Trainer:
    """The trainer of ``args.method`` (the CLI's dispatcher); ``kw`` goes
    to the trainer (``make_optimizer``, ``device``)."""
    common = dict(labeled_bs=args.labeled_bs, consistency=args.consistency,
                  consistency_rampup=args.consistency_rampup, **kw)
    if args.method == "mean_teacher":
        return MeanTeacherTrainer(model, cfg, **common)
    if args.method == "uamt":
        return UAMTTrainer(model, cfg, **common)
    if args.method == "cross_teaching":
        if model2 is None:
            raise ValueError("cross_teaching needs model2")
        return CrossTeachingTrainer(model, cfg, model2=model2, **common)
    raise ValueError(f"unknown method {args.method}")
