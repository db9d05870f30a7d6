"""MagicNet: cube partition and recovery, cube-location reasoning and
debiased pseudo-label blending, with an EMA teacher.

Port of ``mamba_unet_tpu/train/magicnet.py`` (``magic_dice``,
``magic_dice_labels``, ``MagicNetTrainer``; the reference's
``train_Semi_MagicNet_2D.py``, ``train_Semi_MagicNet_3D_for_BTCV.py`` and,
with ``mask_recovery``, ``train_Semi_Mamba_2D_mask.py``), rank-generic
through the cube ops: a 2-D model (``magicnet_2D``, ``magicnet_2D_mask``,
``MambaUnetMask``) on slices or the 3-D ``magicnet`` on volumes. A batch
is ``labeled_bs`` labeled samples, then unlabeled ones. Per step, with the
model in eval mode (no drop path, BatchNorm on its running statistics;
gradients flow), as the JAX step applies it ``deterministic``:

* the EMA teacher's logits of the unlabeled part plus clip(0.1 N(0, 1),
  +-0.2), no grad (SS2D's serving kernel), and their argmax;
* sup: CE + MagicDice of the clean outputs on the labeled part, plus the
  MagicDice of the cross-image recovery (the batch with its cubes
  shuffled across samples, the embedding un-shuffled, the prediction
  head) and of the within-image recovery (every cube encoded and decoded
  alone, the cube embeddings reassembled, the head);
* loc: CE of the location head on each cube's flattened bottleneck; the
  head runs in train mode with its batch statistics thrown away;
* the pseudo-labels: after ``blend_after`` steps and once the class
  histogram is non-zero, the argmax of the teacher's logits blended with
  the reassembled cube logits by w = norm(dist^(1/t_dist)) (normalized by
  the sum, then by the max, in fp32 as JAX) at the teacher's class;
  before, the teacher's argmax;
* cons: MagicDice of the cross-image recovery's unlabeled part against
  them, weighted by ``consistency`` x sigmoid_rampup((step x 150 //
  rampup_stride) // 150, ``consistency_rampup``) at the step before the
  update;
* total = sup / 4 + 0.1 loc + w cons; with ``mask_recovery`` plus the
  clean-vs-shuffled, clean-vs-masked and shuffled-vs-masked MSEs of
  ``forward_mix_pos_mask``, its three passes in train mode (drop path and
  the heads' batch statistics, thrown away). This is the JAX composition;
  the reference overwrites its shuffled term with the cross term, which
  JAX documents and does not copy.

Then the optimizer (a parameter the loss does not reach still decays),
and the EMA of every parameter with decay min(1 - 1 / (t + 1), 0.99) at
the incremented step. The histogram of the used pseudo-labels is summed
on the device; every 20 steps it *replaces* the class distribution (read
once, on the host), as the JAX trainer's 20-step refresh. The periodic
checkpoint carries the EMA and the class distribution beside the model.

Draws come from the trainer's generator, reseeded per step and stream:
the cross-batch cube shuffle (0), the teacher noise (1), the location and
mix heads' drop path (2, the same for each pass, as JAX reuses one key),
the shuffle ids (3) and the visibility mask (4) of the recovery inputs.
The tests hand in JAX's draws through :meth:`MagicNetTrainer._draws`.

Over a data axis of S ranks each rank holds labeled_bs / S labeled and
(B - labeled_bs) / S unlabeled rows. The draws and the inputs built from
them (the cube-shuffled, shuffled and masked images) are made from the
global batch, which every rank holds, and each rank keeps its rows; the
un-mixing of the cross-image embedding needs every rank's rows, so it
runs on their gather (:func:`~mamba_unet_torch.parallel.comm.gather_rows`)
and keeps this rank's; the cube passes' rows are each sample's cubes.
Every loss term's sums are taken over the ranks, and the pseudo-label
histogram is summed over them, so every rank blends with the same class
distribution.

Evaluation is the slice protocol for 2-D patches and sliding-window
``validation_all_case`` (stride max(cube_size // 2, 16)) for 3-D ones;
:meth:`MagicNetTrainer.final_validation` evaluates the saved ``best``
model and writes ``metric_final.npy``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from mamba_unet_torch.nn.layers import at_least_fp32
from mamba_unet_torch.objectives import cross_entropy_loss
from mamba_unet_torch.objectives.cube import (
    OrganClassLogger,
    apply_cube_permutation,
    cube_shuffle_indices,
    get_patch_list,
    random_permutations,
    unmix_patches,
)
from mamba_unet_torch.objectives.masked import (
    make_masked_input,
    make_shuffled_input,
    recovery_mse,
)
from mamba_unet_torch.parallel.comm import (
    all_reduce,
    batch_shard,
    gather_rows,
)
from mamba_unet_torch.train.methods import rampup_weight
from mamba_unet_torch.train.state import ema_update
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    call_discarding_stats,
    log,
    zero_unreached_grads,
)
from mamba_unet_torch.utils.checkpoint import latest_step, restore_checkpoint

MIX, NOISE, HEADS, SHUFFLE, MASK = range(5)  # the generator's streams
MAGIC_METHODS = ("forward_encoder", "forward_decoder", "forward_location",
                 "forward_prediction_head")
HIST_REFRESH = 20  # steps between class-distribution refreshes
_SMOOTH = 1e-10


def magic_dice(probs: torch.Tensor, target_onehot: torch.Tensor,
               weight_map: Optional[torch.Tensor] = None,
               group=None) -> torch.Tensor:
    """MagicDiceLoss: per class 1 - (2 sum(p t) + s) / (sum(p²) + sum(t²)
    + s), s = 1e-10, the target weighted by ``weight_map`` when given,
    averaged over the classes; fp32. With a ``group`` the per-class sums
    are taken over its ranks' rows of the global batch."""
    t = at_least_fp32(target_onehot)
    if weight_map is not None:
        t = t * weight_map
    p = at_least_fp32(probs)
    dims = tuple(range(p.dim() - 1))
    pt, pp, tt = all_reduce(torch.stack([
        (p * t).sum(dims), (p * p).sum(dims), (t * t).sum(dims)]), group)
    inter = 2 * pt + _SMOOTH
    union = pp + tt + _SMOOTH
    return (1.0 - inter / union).mean()


def magic_dice_labels(probs: torch.Tensor, labels: torch.Tensor,
                      weight_map: Optional[torch.Tensor] = None,
                      group=None) -> torch.Tensor:
    return magic_dice(probs, F.one_hot(labels.long(), probs.shape[-1]),
                      weight_map, group)


class MagicNetTrainer(Trainer):
    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 labeled_bs: int = 12, cube_size: int = 32,
                 consistency: float = 0.1, consistency_rampup: float = 200.0,
                 rampup_stride: int = 350, t_dist: float = 0.1,
                 ema_decay: float = 0.99, blend_after: int = 100,
                 mask_recovery: bool = False, masked_rate: float = 0.25,
                 **kw):
        """``model`` has the MagicNet methods (:data:`MAGIC_METHODS`; with
        ``mask_recovery`` also ``forward_mix_pos_mask``). ``kw`` goes to
        :class:`Trainer` (``make_optimizer``, ``device``)."""
        needed = MAGIC_METHODS + (("forward_mix_pos_mask",)
                                  if mask_recovery else ())
        missing = [m for m in needed if not hasattr(model, m)]
        if missing:
            raise ValueError(
                f"MagicNet{' with mask_recovery' if mask_recovery else ''} "
                f"needs a model with {', '.join(needed)}; "
                f"{type(model).__name__} has no {', '.join(missing)}")
        self.labeled_bs = labeled_bs
        self.cube_size = cube_size
        self.consistency = consistency
        self.consistency_rampup = consistency_rampup
        self.rampup_stride = rampup_stride
        self.t_dist = t_dist
        self.ema_decay = ema_decay
        self.blend_after = blend_after
        self.mask_recovery = mask_recovery
        self.masked_rate = masked_rate
        super().__init__(model, config, **kw)
        self.ema = {n: p.detach().clone()
                    for n, p in self.model.named_parameters()}
        self.dist_logger = OrganClassLogger(config.num_classes)
        # the used pseudo-labels' histogram since the last refresh
        self._hist = torch.zeros(config.num_classes, dtype=torch.long,
                                 device=self.device)

    def _blocks(self):
        return (self.labeled_bs, self.config.batch_size - self.labeled_bs)

    # --- one step ---------------------------------------------------------
    def _draws(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step's draws: ``part`` and ``rec``, the cross-batch cube
        permutation and its inverse (B, nb, ...); ``noise``, the teacher's
        clipped noise on the unlabeled part; with ``mask_recovery``
        ``perms`` (B, cubes) and ``vis`` (B, cubes)."""
        b, dev = image.shape[0], image.device
        nb = image.shape[1] // self.cube_size
        self._reseed(MIX)
        part, rec = cube_shuffle_indices(self.generator, b, nb,
                                         image.dim() - 2, dev)
        self._reseed(NOISE)
        noise = torch.randn(image[self.labeled_bs:].shape, device=dev,
                            generator=self.generator)
        draws = {"part": part, "rec": rec,
                 "noise": (0.1 * noise).clamp(-0.2, 0.2)}
        if self.mask_recovery:
            self._reseed(SHUFFLE)
            draws["perms"] = random_permutations(self.generator, b, nb * nb,
                                                 dev)
            self._reseed(MASK)
            draws["vis"] = (torch.rand(b, nb * nb, device=dev,
                                       generator=self.generator)
                            > self.masked_rate).float()
        return draws

    def _teacher(self, x: torch.Tensor) -> torch.Tensor:
        """The EMA teacher's fp32 logits of ``x``: eval mode, no grad."""
        buffers = dict(self.model.named_buffers())
        with torch.no_grad(), self._autocast():
            out, _ = functional_call(self.model, (self.ema, buffers), (x,))
        return at_least_fp32(out)

    def _head(self, method: str, *args) -> torch.Tensor:
        """``model.<method>(*args)`` in train mode with its batch
        statistics thrown away, drop path from the heads' stream."""
        self._reseed(HEADS)
        self.model.train()
        try:
            return call_discarding_stats(self.model, method, *args)
        finally:
            self.model.eval()

    def _blend_weight(self, class_dist: np.ndarray,
                      teacher_class: torch.Tensor) -> torch.Tensor:
        """norm(dist^(1/t_dist)) gathered at the teacher's class, (..., 1),
        in fp32 on the device. The counts are scaled to a maximum of 1
        before the power, which the two normalizations after it cancel:
        the JAX step's weights wherever its fp32 power is finite, and
        finite weights where it overflows (a class counted more than about
        7,000 times at t_dist = 0.1 gives inf there, then NaN)."""
        dist = torch.as_tensor(class_dist, dtype=torch.float32,
                               device=teacher_class.device)
        dist = dist / dist.max().clamp_min(1e-12)
        dist = dist ** (1.0 / self.t_dist)
        dist = dist / dist.sum().clamp_min(1e-12)
        dist = dist / dist.max().clamp_min(1e-12)
        return dist[teacher_class][..., None]

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        lb, model, dev = self.labeled_bs, self.model, self.device
        g = self.group
        image = at_least_fp32(batch["image"].to(dev, non_blocking=True))
        label = batch["label"].to(dev, non_blocking=True).long()
        blocks = (lb, image.shape[0] - lb)
        nb = image.shape[1] // self.cube_size
        cubes = nb ** (image.dim() - 2)
        d = self._draws(image)
        class_dist = self.dist_logger.get_class_dist().astype(np.float32)
        use_blend = bool(self.step > self.blend_after
                         and class_dist.sum() > 0)
        # the inputs built from the global batch, then this rank's rows
        mixed = self._rows(apply_cube_permutation(image, d["part"], nb),
                           *blocks)
        if self.mask_recovery:
            shuffled, _ = make_shuffled_input(image, self.cube_size,
                                              perms=d["perms"])
            masked, _ = make_masked_input(image, self.cube_size,
                                          self.masked_rate, vis=d["vis"])
            shuffled, masked, perms, vis = (
                self._rows(t, *blocks)
                for t in (shuffled, masked, d["perms"], d["vis"]))
        teacher_in = self._rows(image[lb:] + d["noise"], blocks[1])
        image, label = self._rows(image, *blocks), self._rows(label[:lb], lb)
        lb, b = self._local(lb), image.shape[0]  # this rank's rows
        shard = self._shard_of(*blocks)
        model.eval()  # deterministic passes; the grad mode is untouched
        ema_out = self._teacher(teacher_in)
        teacher_class = F.softmax(ema_out, -1).argmax(-1)
        self.optimizer.zero_grad(set_to_none=True)
        with self._autocast(), batch_shard(shard):
            outputs, _ = model(image)
            _, emb_mix = model(mixed)
            # un-mixing reaches every rank's rows: on their gather
            out_unmix = model.forward_prediction_head(self._rows(
                apply_cube_permutation(gather_rows(emb_mix, shard), d["rec"],
                                       nb), *blocks))
            # every cube through the encoder, its location from the
            # bottleneck, and through the decoder alone
            patches = get_patch_list(image, self.cube_size)
            feats = model.forward_encoder(
                patches.reshape(b * cubes, *patches.shape[2:]))
            with batch_shard(None if shard is None else shard.scaled(cubes)):
                loc_logits = self._head("forward_location",
                                        feats[-1].reshape(b * cubes, -1))
            cube_preds, cube_embeds = model.forward_decoder(feats)
            pred_all_unmix = model.forward_prediction_head(unmix_patches(
                cube_embeds.reshape(b, cubes, *cube_embeds.shape[1:]), nb))
            if self.mask_recovery:
                clean = self._head("forward_mix_pos_mask", image)
                shuf = self._head("forward_mix_pos_mask", shuffled,
                                  perms.float())
                mask = self._head("forward_mix_pos_mask", masked, None, vis)
        with torch.autocast(dev.type, enabled=False):
            outputs = at_least_fp32(outputs)
            out_unmix = at_least_fp32(out_unmix)
            soft = F.softmax(outputs, -1)
            soft_unmix = F.softmax(out_unmix, -1)
            sup = (cross_entropy_loss(outputs[:lb], label, group=g)
                   + magic_dice_labels(soft[:lb], label, group=g)
                   + magic_dice_labels(soft_unmix[:lb], label, group=g)
                   + magic_dice_labels(
                       F.softmax(at_least_fp32(pred_all_unmix), -1)[:lb],
                       label, group=g))
            loc = cross_entropy_loss(
                at_least_fp32(loc_logits),
                torch.arange(cubes, device=dev).repeat(b), group=g)
            if use_blend:
                weight = self._blend_weight(class_dist, teacher_class)
                cube_pl = unmix_patches(at_least_fp32(
                    cube_preds.detach()).reshape(
                        b, cubes, *cube_preds.shape[1:]), nb)[lb:]
                blended = (1.0 - weight) * ema_out + weight * cube_pl
                pseudo = F.softmax(blended, -1).argmax(-1)
            else:
                pseudo = teacher_class
            cons = magic_dice_labels(soft_unmix[lb:], pseudo, group=g)
            w = rampup_weight(self.step * 150 // self.rampup_stride,
                              self.consistency, self.consistency_rampup)
            total = sup / 4.0 + 0.1 * loc + w * cons
            logs = {"loss_sup": sup.detach() / 4.0, "loss_loc": loc.detach(),
                    "loss_cons": cons.detach()}
            if self.mask_recovery:
                recovery = (recovery_mse(clean, shuf, g)
                            + recovery_mse(clean, mask, g)
                            + recovery_mse(shuf, mask, g))
                total = total + recovery
                logs["loss_recv"] = recovery.detach()
        # the histogram of the global batch's pseudo-labels
        hist = all_reduce(torch.bincount(pseudo.reshape(-1),
                                         minlength=self.config.num_classes),
                          g)
        self._hist += hist
        total.backward()
        zero_unreached_grads(model)
        self._reduce_grads(model)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        ema_update(self.ema, dict(model.named_parameters()), self.step,
                   self.ema_decay)
        model.train()
        return {"loss_total": total.detach(), **logs, "cons_weight": w,
                "class_hist": hist, "lr": self.scheduler.get_last_lr()[0]}

    def _after_step(self, batch, logs) -> None:
        """Every HIST_REFRESH steps the summed histogram becomes the class
        distribution (one read of the device)."""
        if self.step % HIST_REFRESH == 0:
            self.dist_logger.class_dist = self._hist.cpu().numpy().astype(
                np.float64)
            self._hist.zero_()

    # --- checkpoints ------------------------------------------------------
    def _periodic_tree(self) -> Dict[str, Any]:
        return {**super()._periodic_tree(), "ema": self.ema,
                "class_dist": torch.from_numpy(
                    self.dist_logger.get_class_dist())}

    def _load_periodic(self, tree: Dict[str, Any]) -> None:
        super()._load_periodic(tree)
        for n, t in self.ema.items():
            t.copy_(tree["ema"][n])
        if "class_dist" in tree:
            self.dist_logger.class_dist = np.asarray(
                tree["class_dist"].cpu().numpy(), np.float64)
            self._hist.zero_()

    # --- evaluation -------------------------------------------------------
    def _stride(self):
        return (max(self.cube_size // 2, 16),) * 3

    def evaluate(self, val_dataset, model: Optional[nn.Module] = None
                 ) -> float:
        """2-D patches: the slice protocol. 3-D: the mean Dice of
        sliding-window ``validation_all_case``."""
        if len(self.config.patch_size) == 2:
            return super().evaluate(val_dataset, model)
        return float(self.validate_3d(val_dataset, model)[:, :, 0].mean())

    def validate_3d(self, dataset, model: Optional[nn.Module] = None
                    ) -> np.ndarray:
        """(cases, classes - 1, 4) [dice, hd95, nsd, asd] of ``model``
        (default the trained one), one device call per window."""
        from mamba_unet_torch.eval.validate_3d import validation_all_case

        model = self.model if model is None else model
        try:
            return validation_all_case(
                dataset, self.predict_fn(model), self.config.num_classes,
                patch_size=tuple(self.config.patch_size),
                stride=self._stride())
        finally:
            model.train()

    def final_validation(self, test_dataset,
                         save_name: str = "metric_final") -> np.ndarray:
        """The end-of-run protocol of the reference's BTCV script: the
        saved ``best`` model (the live weights when there is none) over
        ``test_dataset``, sliding window for 3-D patches ((cases, C - 1,
        4)) or the slice protocol for 2-D ones ((cases, C - 1, 2)); the
        array is written to ``{snapshot_dir}/{save_name}.npy``. The live
        weights are put back afterwards."""
        from mamba_unet_torch.eval.inference import evaluate_slice_volumes

        cfg = self.config
        step = latest_step(cfg.snapshot_dir, "best") if cfg.snapshot_dir \
            else None
        live = None
        if step is not None:
            live = {k: v.clone() for k, v in self.model.state_dict().items()}
            self.model.load_state_dict(restore_checkpoint(
                cfg.snapshot_dir, step, name="best",
                map_location=self.device))
            log.info("final validation on saved best_%d", step)
        else:
            log.warning("final validation: no saved best, live weights")
        try:
            if len(cfg.patch_size) == 2:
                arr = evaluate_slice_volumes(
                    (test_dataset[i] for i in range(len(test_dataset))),
                    self.predict_fn(), cfg.num_classes,
                    patch_size=cfg.patch_size,
                    batch_size=cfg.eval_batch_size)
            else:
                arr = self.validate_3d(test_dataset)
        finally:
            if live is not None:
                self.model.load_state_dict(live)
            self.model.train()
        arr = np.asarray(arr)
        log.info("final validation: mean dice %.4f over %d cases",
                 float(arr[:, :, 0].mean()), arr.shape[0])
        if cfg.snapshot_dir:
            path = os.path.join(cfg.snapshot_dir, f"{save_name}.npy")
            np.save(path, arr)
            log.info("final metric array -> %s", path)
        return arr
