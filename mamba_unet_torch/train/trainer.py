"""The Trainer: the fully-supervised train step and the loop around it.

Port of ``TrainConfig``, ``fully_supervised_loss`` and ``Trainer`` from
``mamba_unet_tpu/train/trainer.py``, with the same protocol:

* poly LR per iteration (the optimizer's scheduler, ``train/optim.py``),
* eval every ``eval_every`` iterations on the val volumes (order-0 zoom
  slice inference through the no-grad serving scan), tracking the mean
  Dice over classes 1..C-1,
* a best-Dice checkpoint (the model's ``state_dict``) with its high-water
  mark in a sidecar, a periodic checkpoint every ``ckpt_every``
  iterations, and resume from the newest periodic one.

The trainer owns the model, the optimizer and its schedule, the step and
the ``torch.Generator`` that every random module (``DropPath``,
``Dropout``, the UNet family's perturbations) draws from. That generator
is reseeded from (seed, step) before every step, as the JAX trainer folds
the step into its key, so a resumed run draws the same masks. With
``bf16=True`` the forward and the loss run under bf16 autocast; weights,
gradients and the optimizer stay fp32, and the scan keeps an fp32 state.

The hooks the semi-supervised and weakly-supervised methods
(``train/methods.py``, ``train/weak.py``) extend: ``supports_grad_accum``,
``_reseed`` (a further stream of the step's seed), ``_members`` (each
trained network with its optimizer and schedule: the periodic checkpoint
carries them all, and each is evaluated with its own best checkpoint,
``best``, ``best2``, ...; ``_load_best_marks(names)`` reads their marks)
and ``_periodic_tree``/``_load_periodic`` (what else the periodic
checkpoint carries).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mamba_unet_torch.eval.inference import evaluate_slice_volumes
from mamba_unet_torch.nn.layers import set_generator
from mamba_unet_torch.objectives import supervised_ce_dice
from mamba_unet_torch.train.optim import poly_sgd
from mamba_unet_torch.utils.checkpoint import (
    latest_step,
    load_best_marks,
    restore_checkpoint,
    save_best_marks,
    save_checkpoint,
)
from mamba_unet_torch.utils.device import require_device
from mamba_unet_torch.utils.export import make_predict_fn

log = logging.getLogger("mamba_unet_torch")


@dataclasses.dataclass
class TrainConfig:
    base_lr: float = 0.01
    max_iterations: int = 10_000
    batch_size: int = 24
    patch_size: Tuple[int, int] = (256, 256)
    num_classes: int = 4
    eval_every: int = 200
    ckpt_every: int = 3000
    eval_batch_size: int = 16
    seed: int = 1337
    snapshot_dir: Optional[str] = None
    log_every: int = 50
    resume: bool = False
    # k microbatches per optimizer update: each is run forward and backward
    # on its own (activation memory scales with batch_size / k) and the
    # gradient is the mean over them; the Dice term becomes per-microbatch
    grad_accum_steps: int = 1
    # bf16 autocast for the forward and the loss (the JAX package builds
    # its model with dtype=bfloat16 instead)
    bf16: bool = False


def fully_supervised_loss(model: nn.Module, batch: Dict[str, torch.Tensor]
                          ) -> Tuple[torch.Tensor, Dict]:
    """0.5 * (CE + Dice) on the whole batch; a multi-head model trains on
    its main head."""
    logits = model(batch["image"])
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    loss = supervised_ce_dice(logits, batch["label"])
    return loss, {"loss_total": loss.detach()}


def _suffix(i: int) -> str:
    """The name suffix of the (0-based) i-th member: "", "2", "3", ..."""
    return str(i + 1) if i else ""


def _step_seed(seed: int, step: int, *stream: int) -> int:
    """A 63-bit seed mixed from (seed, step, *stream)."""
    state = np.random.SeedSequence([seed, step, *stream]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


OptimizerFactory = Callable[[Any], Tuple[torch.optim.Optimizer, Any]]


class Trainer:
    # a subclass whose step is not the base step's microbatch loop sets
    # this False, so that grad_accum_steps > 1 raises instead of being
    # ignored
    supports_grad_accum: bool = True

    def __init__(self, model: nn.Module, config: TrainConfig,
                 make_optimizer: Optional[OptimizerFactory] = None,
                 device="cuda"):
        """``make_optimizer(params) -> (optimizer, scheduler)``, by default
        :func:`poly_sgd` at ``config.base_lr`` over
        ``config.max_iterations``. The model moves to ``device``, which is
        the card unless the caller asks for the CPU."""
        cfg = self.config = config
        k = cfg.grad_accum_steps
        if k > 1 and not self.supports_grad_accum:
            raise ValueError(f"{type(self).__name__} does not support "
                             f"grad_accum_steps > 1")
        if k < 1 or cfg.batch_size % k:
            raise ValueError(f"batch_size={cfg.batch_size} is not divisible "
                             f"by grad_accum_steps={k}")
        self.device = require_device(device)
        self.model = model.to(self.device).train()
        if make_optimizer is None:
            def make_optimizer(params):
                return poly_sgd(params, cfg.base_lr, cfg.max_iterations)
        self.make_optimizer = make_optimizer
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters())
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        set_generator(self.model, self.generator)

    def _reseed(self, *stream: int) -> None:
        """Reseed the generator from (seed, step, *stream)."""
        self.generator.manual_seed(
            _step_seed(self.config.seed, self.step, *stream))

    def _autocast(self):
        return torch.autocast(self.device.type, torch.bfloat16,
                              enabled=self.config.bf16)

    # --- one step --------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One optimizer update on ``batch`` (``image`` (B, H, W, C) float,
        ``label`` (B, H, W) int). Returns the logs, as device tensors where
        they come from the device (reading them synchronises)."""
        cfg = self.config
        self.model.train()
        self._reseed()
        image = batch["image"].to(self.device, non_blocking=True).float()
        label = batch["label"].to(self.device, non_blocking=True).long()
        k = cfg.grad_accum_steps
        self.optimizer.zero_grad(set_to_none=True)
        losses = []
        for img, lab in zip(image.chunk(k), label.chunk(k)):
            with self._autocast():
                loss, logs = fully_supervised_loss(
                    self.model, {"image": img, "label": lab})
            (loss / k).backward()
            losses.append(logs["loss_total"])
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss_total": torch.stack(losses).mean(),
                "lr": self.scheduler.get_last_lr()[0]}

    # --- eval -------------------------------------------------------------
    def predict_fn(self, model: Optional[nn.Module] = None) -> Callable:
        """(B, ps, ps, 1) fp32 -> logits of ``model`` (default the trained
        one), no grad, in eval mode: the serving scan kernel (bf16 autocast
        when training in bf16)."""
        return make_predict_fn(self.model if model is None else model,
                               torch.bfloat16 if self.config.bf16 else None)

    def evaluate(self, val_dataset, model: Optional[nn.Module] = None
                 ) -> float:
        """Mean Dice of ``model`` (default the trained one) over val
        volumes x foreground classes."""
        cfg = self.config
        model = self.model if model is None else model
        try:
            arr = evaluate_slice_volumes(
                (val_dataset[i] for i in range(len(val_dataset))),
                self.predict_fn(model), cfg.num_classes,
                patch_size=cfg.patch_size, batch_size=cfg.eval_batch_size,
            )  # (cases, classes-1, 2)
        finally:
            model.train()
        return float(arr[:, :, 0].mean())

    def _members(self) -> List[Tuple[nn.Module, Any, Any]]:
        """(model, optimizer, scheduler) of each trained network, the
        first being ``model``."""
        return [(self.model, self.optimizer, self.scheduler)]

    def _best_models(self) -> List[Tuple[str, nn.Module]]:
        """(best checkpoint name, model) of each model evaluated: ``best``,
        ``best2``, ... in :meth:`_members` order."""
        return [(f"best{_suffix(i)}", model)
                for i, (model, _, _) in enumerate(self._members())]

    # --- checkpoints --------------------------------------------------------
    def _periodic_tree(self) -> Dict[str, Any]:
        """Every member's ``model``, ``optimizer`` and ``scheduler`` (the
        second's ``model2``, ...) and the step."""
        tree = {"step": self.step}
        for i, (model, opt, sched) in enumerate(self._members()):
            tree.update({f"model{_suffix(i)}": model.state_dict(),
                         f"optimizer{_suffix(i)}": opt.state_dict(),
                         f"scheduler{_suffix(i)}": sched.state_dict()})
        return tree

    def _load_periodic(self, tree: Dict[str, Any]) -> None:
        """Inverse of :meth:`_periodic_tree` (the step aside)."""
        for i, (model, opt, sched) in enumerate(self._members()):
            model.load_state_dict(tree[f"model{_suffix(i)}"])
            opt.load_state_dict(tree[f"optimizer{_suffix(i)}"])
            sched.load_state_dict(tree[f"scheduler{_suffix(i)}"])

    def try_resume(self) -> int:
        """Restore the newest periodic checkpoint of ``snapshot_dir`` when
        ``resume``; returns the step, or 0 when there is none."""
        cfg = self.config
        if not (cfg.resume and cfg.snapshot_dir):
            return 0
        step = latest_step(cfg.snapshot_dir)
        if step is None:
            return 0
        tree = restore_checkpoint(cfg.snapshot_dir, step,
                                  map_location=self.device)
        self._load_periodic(tree)
        self.step = int(tree["step"])
        log.info("resumed from %s @ step %d", cfg.snapshot_dir, self.step)
        return self.step

    def _load_best_marks(self, names: Sequence[str] = ("best",)
                         ) -> List[float]:
        """The best Dice so far of each of ``names`` from the sidecar (0.0
        when absent), so a resumed run cannot overwrite a better ``best_*``
        checkpoint."""
        marks = (load_best_marks(self.config.snapshot_dir)
                 if self.config.snapshot_dir else {})
        return [float(marks.get(n, 0.0)) for n in names]

    # --- the loop -----------------------------------------------------------
    def fit(self, train_loader, val_dataset=None) -> Dict[str, Any]:
        """Train to ``max_iterations``; returns ``iterations``, ``history``
        and ``best_dice`` (``best_dice2``, ... for further models)."""
        cfg = self.config
        history = []
        it0 = self.try_resume()
        names = [name for name, _ in self._best_models()]
        # the marks load whenever resume is asked for, not only when a
        # periodic checkpoint exists: a run killed after a best save but
        # before its first periodic save must keep its best
        best = dict(zip(names, self._load_best_marks(names) if cfg.resume
                        else [0.0] * len(names)))
        t0 = time.time()
        for batch in train_loader:
            if self.step >= cfg.max_iterations:
                break
            logs = self.train_step(batch)
            it = self.step
            if it % cfg.log_every == 0 or it == 1:
                loss = float(logs["loss_total"])
                log.info("iter %d loss %.4f lr %.5f (%.1f it/s)", it, loss,
                         logs["lr"], (it - it0) / (time.time() - t0))
                history.append({"iter": it, "loss": loss})
            if val_dataset is not None and it % cfg.eval_every == 0:
                entry = {"iter": it}
                for name, model in self._best_models():
                    dice = self.evaluate(val_dataset, model=model)
                    log.info("iter %d val mean dice (%s) %.4f (best %.4f)",
                             it, name, dice, best[name])
                    entry["val_dice" + name[len("best"):]] = dice
                    if dice > best[name]:
                        best[name] = dice
                        if cfg.snapshot_dir:
                            save_checkpoint(cfg.snapshot_dir, it,
                                            model.state_dict(), name=name)
                            save_best_marks(cfg.snapshot_dir, {name: dice})
                history.append(entry)
            if cfg.snapshot_dir and it % cfg.ckpt_every == 0:
                save_checkpoint(cfg.snapshot_dir, it, self._periodic_tree())
        result = {"iterations": self.step, "history": history}
        result.update({"best_dice" + name[len("best"):]: value
                       for name, value in best.items()})
        return result
