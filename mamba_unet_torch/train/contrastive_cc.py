"""Contrastive consistency: two networks, CTAugment views and projectors.

Port of ``mamba_unet_tpu/train/contrastive_cc.py``
(``ContrastiveConsistencyTrainer``). A batch is ``labeled_bs`` labeled
samples then unlabeled ones, each seen as a weak and a strong CTAugment
view (``data/cta_transform.py``); the labels follow the weak ops. Per
step:

* sup: CE + Dice (the unhalved sum) of both models' weak outputs on the
  labeled part;
* pseudo-labels: each model's weak softmax min-max normalized per pixel
  over the classes, zeroed under 0.95, the two averaged, argmax; no
  gradient;
* unsup: CE + Dice of each model's strong outputs against them;
* contrastive: patch-NCE (``objectives.contrastive.con_loss``) between
  projector 3 of model 1's and projector 4 of model 2's weak outputs on
  the labeled part; on the unlabeled part the cross pairs projector
  1(weak 1) / projector 4(strong 2) and projector 2(weak 2) / projector
  3(strong 1), where projectors 1 and 2 are EMA copies (decay 0.999) of
  3 and 4 that normalize with 3's and 4's BatchNorm buffers;
* loss = sup + w1 (contrast_l + unsup) + w2 contrast_u, w_i =
  consistency_i * sigmoid_rampup(step // 150, 200) at the step before
  the update (consistency1 = 1, consistency2 = 0.1).

One backward of the sum; each model and trained projector (3, 4) has its
own optimizer and schedule from the same ``make_optimizer``; then the EMA
of projectors 1 and 2 with a = min(1 - 1 / (step + 1), 0.999) at the
step before the increment, so the first update copies 3 and 4. As in the
JAX step, each model keeps the BatchNorm statistics of its weak pass
only, the projectors' and the strong passes' are thrown away
(:func:`~mamba_unet_torch.train.trainer.call_discarding_stats`), and the
projectors and the losses run in fp32 with autocast off, on the fp32
logits. A parameter the loss does not reach still decays
(:func:`~mamba_unet_torch.train.trainer.zero_unreached_grads`).

``mask_recovery`` (the JAX trainer's ``_mask`` variant, reachable through
this API only: both CLIs refuse the flag for this method) adds
``mask_weight`` x the shuffled + masked recovery MSE of model 1's
``forward_mix_pos_mask`` head (a ``MambaUnetMask``) on the weak view,
cubes of ``mask_cube_size``; its three passes throw their statistics
away.

``fit(loader, val, cta=, cta_transform=)`` runs :class:`Trainer`'s loop
and, after every step, reads the loss on the host (half of it is the
step's error), refreshes the policy on an unfavorable crop (labels but
under 0.5 % labeled after the weak ops), and at the end of each epoch of
the loader updates the bin rates with proximity 1 - mean(errors) and
refreshes the policy. Both models are evaluated with their own best
checkpoints (``best``, ``best2``); the periodic checkpoint carries both
models, the trained projectors and their optimizers, the EMA projectors
and the step, and ``cta_state.json`` is written beside it.

The draws: the four model passes on streams 0-3 of the step's seed (the
JAX step's rngs[0..3]), the shuffle and mask draws on stream 4, the mix
heads' drop-path on stream 5 (the same for the three passes, as JAX reuses
one key).

Over a data axis of S ranks each rank holds labeled_bs / S labeled and
(B - labeled_bs) / S unlabeled rows of each view; the shuffle ids and the
visibility mask are drawn for the global batch; every loss term's sums
(the patch-NCE's mean over B·N and the recovery MSEs included) are taken
over the ranks, and the two models' and the trained projectors' gradients
summed in one all-reduce, so the projectors' EMA and the loss that
CTAugment reads on the host are the same on every rank. The batch that
``_after_step`` reads is the global batch that every rank is handed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mamba_unet_torch.models.small_nets import Projectors
from mamba_unet_torch.objectives import (
    cross_entropy_loss,
    dice_loss_from_labels,
)
from mamba_unet_torch.objectives.contrastive import con_loss
from mamba_unet_torch.objectives.cube import random_permutations
from mamba_unet_torch.objectives.masked import (
    make_masked_input,
    make_shuffled_input,
    recovery_mse,
)
from mamba_unet_torch.parallel.comm import batch_shard
from mamba_unet_torch.train.methods import _main_head, rampup_weight
from mamba_unet_torch.train.state import ema_update
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    call_discarding_stats,
    log,
    zero_unreached_grads,
)
from mamba_unet_torch.utils.checkpoint import load_cta_state, save_cta_state

WEAK1, STRONG1, WEAK2, STRONG2, PERTURB, MIX_HEAD = range(6)  # streams
MASKED_RATE = 0.25  # the mask variant's share of masked cubes


def _minmax_normalize(soft: torch.Tensor) -> torch.Tensor:
    """Per-pixel (soft - min) / max over the classes."""
    mn = soft.amin(-1, keepdim=True)
    mx = soft.amax(-1, keepdim=True)
    return (soft - mn) / mx.clamp_min(1e-12)


def _ce_dice(logits: torch.Tensor, labels: torch.Tensor, group=None
             ) -> torch.Tensor:
    return (cross_entropy_loss(logits, labels, group=group)
            + dice_loss_from_labels(F.softmax(logits, -1), labels,
                                    group=group))


class ContrastiveConsistencyTrainer(Trainer):
    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 model2: nn.Module, labeled_bs: int = 12,
                 conf_thresh: float = 0.95, consistency1: float = 1.0,
                 consistency2: float = 0.1, consistency_rampup: float = 200.0,
                 ema_decay: float = 0.999, projector_ndf: int = 8,
                 mask_recovery: bool = False, mask_cube_size: int = 32,
                 mask_weight: float = 1.0,
                 projectors: Optional[Tuple[nn.Module, nn.Module]] = None,
                 **kw):
        """``model2`` is built by the caller with its own initialization
        (the CLI seeds it with ``seed + 1``); ``projectors`` (3, 4) by
        default are ``Projectors(num_classes, projector_ndf)`` seeded with
        ``seed + 2`` and ``seed + 3``. ``kw`` goes to :class:`Trainer`
        (``make_optimizer``, ``device``)."""
        self.labeled_bs = labeled_bs
        self.conf_thresh = conf_thresh
        self.consistency1 = consistency1
        self.consistency2 = consistency2
        self.consistency_rampup = consistency_rampup
        self.ema_decay = ema_decay
        self.mask_recovery = mask_recovery
        self.mask_cube_size = mask_cube_size
        self.mask_weight = mask_weight
        super().__init__(model, config, **kw)
        if mask_recovery and not hasattr(self.model, "forward_mix_pos_mask"):
            raise ValueError(f"mask_recovery needs a model with "
                             f"forward_mix_pos_mask (MambaUnetMask), not "
                             f"{type(self.model).__name__}")
        self.model2 = self._adopt(model2)
        self.optimizer2, self.scheduler2 = self.make_optimizer(
            self.model2.parameters())
        if projectors is None:
            projectors = tuple(
                Projectors(config.num_classes, projector_ndf,
                           generator=torch.Generator().manual_seed(
                               config.seed + s))
                for s in (2, 3))
        self.p3, self.p4 = (self._adopt(p) for p in projectors)
        self.optimizer3, self.scheduler3 = self.make_optimizer(
            self.p3.parameters())
        self.optimizer4, self.scheduler4 = self.make_optimizer(
            self.p4.parameters())
        self.p1, self.p2 = ({n: p.detach().clone()
                             for n, p in proj.named_parameters()}
                            for proj in (self.p3, self.p4))
        self.cta = self.cta_transform = None
        self._per_epoch = 1
        self._epoch_errors: List[float] = []

    def _blocks(self):
        return (self.labeled_bs, self.config.batch_size - self.labeled_bs)

    # --- members, checkpoints --------------------------------------------
    def _members(self):
        return [(self.model, self.optimizer, self.scheduler),
                (self.model2, self.optimizer2, self.scheduler2)]

    def _projectors(self):
        return [(self.p3, self.optimizer3, self.scheduler3),
                (self.p4, self.optimizer4, self.scheduler4)]

    def _periodic_tree(self) -> Dict[str, Any]:
        tree = super()._periodic_tree()
        for name, (proj, opt, sched) in zip(("p3", "p4"),
                                            self._projectors()):
            tree.update({name: proj.state_dict(),
                         f"{name}_optimizer": opt.state_dict(),
                         f"{name}_scheduler": sched.state_dict()})
        return {**tree, "p1": self.p1, "p2": self.p2}

    def _load_periodic(self, tree: Dict[str, Any]) -> None:
        super()._load_periodic(tree)
        for name, (proj, opt, sched) in zip(("p3", "p4"),
                                            self._projectors()):
            proj.load_state_dict(tree[name])
            opt.load_state_dict(tree[f"{name}_optimizer"])
            sched.load_state_dict(tree[f"{name}_scheduler"])
        for ema, name in ((self.p1, "p1"), (self.p2, "p2")):
            for n, t in ema.items():
                t.copy_(tree[name][n])

    def _save_periodic(self, it: int) -> None:
        super()._save_periodic(it)
        if self.cta is not None:
            # beside the periodic tree, so a kill between the two loses at
            # most one cadence of learned rates
            save_cta_state(self.config.snapshot_dir, self.cta)

    def try_resume(self) -> int:
        """The base resume, then the CTAugment rates of ``cta_state.json``
        (and fresh policies drawn from them)."""
        step = super().try_resume()
        snap = self.config.snapshot_dir
        if step and self.cta is not None and load_cta_state(snap, self.cta):
            if self.cta_transform is not None:
                self.cta_transform.refresh_policies()
            log.info("restored the CTAugment rates from %s", snap)
        return step

    # --- one step ---------------------------------------------------------
    def _project(self, proj: nn.Module, x: torch.Tensor, rows: int,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """Projector features of fp32 logits ``x`` (this rank's rows of a
        global batch of ``rows``) in train mode, with ``params`` (an EMA
        copy) in place of the projector's own when given; the BatchNorm
        statistics are thrown away."""
        buffers = {n: b.clone() for n, b in proj.named_buffers()}
        with batch_shard(self._shard_of(rows)):
            return functional_call(proj, {**(params or {}), **buffers},
                                   (x,))

    def _mask_draws(self, image: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shuffle ids, visibility mask), both (B, cubes), from the
        perturbation stream."""
        b = image.shape[0]
        cubes = (image.shape[1] // self.mask_cube_size) ** 2
        self._reseed(PERTURB)
        perms = random_permutations(self.generator, b, cubes, image.device)
        vis = (torch.rand(b, cubes, generator=self.generator,
                          device=image.device) > MASKED_RATE).float()
        return perms, vis

    def _mask_recovery_loss(self, weak: torch.Tensor) -> torch.Tensor:
        """Model 1's shuffled + masked recovery MSE on the weak view (the
        global batch; each rank runs its rows)."""
        perms, vis = self._mask_draws(weak)
        shuffled, _ = make_shuffled_input(weak, self.mask_cube_size,
                                          perms=perms)
        masked, _ = make_masked_input(weak, self.mask_cube_size, MASKED_RATE,
                                      vis=vis)
        blocks = (self.labeled_bs, weak.shape[0] - self.labeled_bs)
        outs = []
        with self._autocast(), batch_shard(self._shard_of(*blocks)):
            for x, pos, mask in ((weak, None, None),
                                 (shuffled, perms.float(), None),
                                 (masked, None, vis)):
                self._reseed(MIX_HEAD)
                outs.append(call_discarding_stats(
                    self.model, "forward_mix_pos_mask",
                    *(None if t is None else self._rows(t, *blocks)
                      for t in (x, pos, mask))))
        return (recovery_mse(outs[0], outs[1], self.group)
                + recovery_mse(outs[0], outs[2], self.group))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        lb, dev, g = self.labeled_bs, self.device, self.group
        weak_all = batch["image_weak"].to(dev, non_blocking=True).float()
        nu = weak_all.shape[0] - lb
        weak = self._rows(weak_all, lb, nu)
        strong = self._rows(batch["image_strong"].to(
            dev, non_blocking=True).float(), lb, nu)
        label = self._rows(batch["label_aug"].to(
            dev, non_blocking=True).long(), lb, nu)
        rows, lb = lb, self._local(lb)  # the global and this rank's labeled
        nets = (self.model, self.model2, self.p3, self.p4)
        opts = self._members() + self._projectors()
        for net in nets:
            net.train()
        for _, opt, _ in opts:
            opt.zero_grad(set_to_none=True)
        with self._autocast(), batch_shard(self._shard_of(rows, nu)):
            self._reseed(WEAK1)
            ow1 = _main_head(self.model(weak))
            self._reseed(STRONG1)
            os1 = _main_head(call_discarding_stats(self.model, "forward",
                                                   strong))
            self._reseed(WEAK2)
            ow2 = _main_head(self.model2(weak))
            self._reseed(STRONG2)
            os2 = _main_head(call_discarding_stats(self.model2, "forward",
                                                   strong))
        with torch.autocast(dev.type, enabled=False):
            ow1, os1, ow2, os2 = (o.float() for o in (ow1, os1, ow2, os2))
            sw1, sw2 = F.softmax(ow1, -1), F.softmax(ow2, -1)
            with torch.no_grad():
                def confident(soft):
                    nrm = _minmax_normalize(soft)
                    return nrm * (nrm > self.conf_thresh)

                pseudo = ((confident(sw1) + confident(sw2)) / 2.0).argmax(-1)
            sup = (cross_entropy_loss(ow1[:lb], label[:lb], group=g)
                   + dice_loss_from_labels(sw1[:lb], label[:lb], group=g)
                   + cross_entropy_loss(ow2[:lb], label[:lb], group=g)
                   + dice_loss_from_labels(sw2[:lb], label[:lb], group=g))
            unsup = (_ce_dice(os1[lb:], pseudo[lb:], g)
                     + _ce_dice(os2[lb:], pseudo[lb:], g))
            contrast_l = con_loss(self._project(self.p3, ow1[:lb], rows),
                                  self._project(self.p4, ow2[:lb], rows),
                                  group=g)
            contrast_u = (
                con_loss(self._project(self.p3, ow1[lb:], nu, self.p1),
                         self._project(self.p4, os2[lb:], nu), group=g)
                + con_loss(self._project(self.p4, ow2[lb:], nu, self.p2),
                           self._project(self.p3, os1[lb:], nu), group=g))
            w1 = rampup_weight(self.step, self.consistency1,
                               self.consistency_rampup)
            w2 = rampup_weight(self.step, self.consistency2,
                               self.consistency_rampup)
            total = sup + w1 * contrast_l + w1 * unsup + w2 * contrast_u
        logs = {"loss_sup": sup.detach(), "loss_unsup": unsup.detach(),
                "loss_contrast_l": contrast_l.detach(),
                "loss_contrast_u": contrast_u.detach()}
        if self.mask_recovery:
            rec = self._mask_recovery_loss(weak_all)
            total = total + self.mask_weight * rec
            logs["loss_mask_recovery"] = rec.detach()
        total.backward()
        zero_unreached_grads(*nets)
        self._reduce_grads(*nets)
        for _, opt, sched in opts:
            opt.step()
            sched.step()
        ema_update(self.p1, dict(self.p3.named_parameters()), self.step,
                   self.ema_decay)
        ema_update(self.p2, dict(self.p4.named_parameters()), self.step,
                   self.ema_decay)
        self.step += 1
        return {"loss_total": total.detach(), **logs, "cons_weight1": w1,
                "cons_weight2": w2, "lr": self.scheduler.get_last_lr()[0]}

    def evaluate2(self, val_dataset) -> float:
        """Model 2's mean val Dice."""
        return self.evaluate(val_dataset, model=self.model2)

    # --- the loop -----------------------------------------------------------
    def _after_step(self, batch: Dict[str, torch.Tensor],
                    logs: Dict[str, Any]) -> None:
        """The CTAugment bookkeeping: the step's error, the unfavorable-
        crop refresh and the end-of-epoch rate update."""
        self._epoch_errors.append(0.5 * float(logs["loss_total"]))
        tf = self.cta_transform
        if tf is not None:
            nz, nz_aug = torch.stack([
                (batch["label"] != 0).float().mean(),
                (batch["label_aug"] != 0).float().mean()]).tolist()
            if nz > 0 and nz_aug < 0.005:
                log.info("refreshing the policy (unfavorable crop)")
                tf.refresh_policies()
        if (self.step % self._per_epoch == 0 and self.cta is not None
                and tf is not None):
            proximity = 1.0 - 0.5 * float(np.mean(self._epoch_errors))
            self.cta.update_rates(tf.ops_weak, proximity)
            self.cta.update_rates(tf.ops_strong, proximity)
            tf.refresh_policies()
            self._epoch_errors = []

    def fit(self, train_loader, val_dataset=None, cta=None,
            cta_transform=None) -> Dict[str, Any]:
        """:meth:`Trainer.fit` with the CTAugment policy ``cta`` that
        ``cta_transform`` (the dataset's transform) draws its ops from; an
        epoch is ``len(train_loader)`` steps."""
        self.cta, self.cta_transform = cta, cta_transform
        self._per_epoch = max(len(train_loader), 1)
        self._epoch_errors = []
        return super().fit(train_loader, val_dataset)
