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
``best``, ``best2``, ...; ``_load_best_marks(names)`` reads their marks),
``_periodic_tree``/``_load_periodic`` (what else the periodic checkpoint
carries), ``_save_periodic`` (what else is written beside it),
``_save_best`` (what a new best Dice writes) and
``_after_step`` (host-side work after each step). :func:`zero_unreached_grads`
gives the parameters a step's loss does not reach a zero gradient, so that
the optimizer still decays them, as the JAX step does with its zero
gradients (``torch.optim.SGD`` skips a parameter whose ``grad`` is None);
:func:`call_discarding_stats` runs a pass whose BatchNorm statistics the
step throws away.

Data parallelism (``mesh``, as the JAX trainer's): over a mesh whose
``data`` axis has S > 1 ranks, each rank runs the step on its rows of the
global batch it is handed, and the step computes what the one-process
step computes on that batch: BatchNorm statistics, the cross-entropy's
mean and the Dice's per-class sums over the global batch, dropout and
drop-path masks drawn for the global batch from the trainer's generator
(each rank keeps its rows), and the gradients summed over the ranks. The
collectives sum the gradients in their backward, so every rank's
gradient is S times its share of the global loss's, and the sum over the
ranks is divided by S once. The ranks start from rank 0's weights;
validation, the scalar log and checkpoints run on rank 0 only. The
multi-model trainers do the same for every member: a rank holds its part
of each block of the batch (:meth:`Trainer._blocks`: a two-stream batch's
labeled and unlabeled rows, so every rank runs every pass), draws what
the step draws for the global batch and keeps its rows (:meth:`_rows`,
:meth:`_shard_of`), takes every loss term over ``group``, and sums every
trained member's gradients in one all-reduce (:meth:`_reduce_grads`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mamba_unet_torch.eval.inference import evaluate_slice_volumes
from mamba_unet_torch.nn.layers import set_generator
from mamba_unet_torch.objectives import supervised_ce_dice
from mamba_unet_torch.parallel.comm import (
    BatchShard,
    batch_shard,
    check_blocks,
)
from mamba_unet_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
)
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
    # scalars (loss, lr, the val mean Dice) into snapshot_dir/log
    # (utils/experiment.py: an event file where tensorboard is installed,
    # and scalars.jsonl)
    tensorboard: bool = False


def fully_supervised_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                          group=None) -> Tuple[torch.Tensor, Dict]:
    """0.5 * (CE + Dice) on the whole batch (over ``group``'s global batch
    when given); a multi-head model trains on its main head."""
    logits = model(batch["image"])
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    loss = supervised_ce_dice(logits, batch["label"], group)
    return loss, {"loss_total": loss.detach()}


def _suffix(i: int) -> str:
    """The name suffix of the (0-based) i-th member: "", "2", "3", ..."""
    return str(i + 1) if i else ""


def _step_seed(seed: int, step: int, *stream: int) -> int:
    """A 63-bit seed mixed from (seed, step, *stream)."""
    state = np.random.SeedSequence([seed, step, *stream]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def zero_unreached_grads(*modules: nn.Module) -> None:
    """A zero ``grad`` for every trainable parameter of ``modules`` that the
    backward did not reach."""
    for module in modules:
        for p in module.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)


class _Method(nn.Module):
    """``module.<method>`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args):
        return getattr(self.module, self.method)(*args)


def call_discarding_stats(module: nn.Module, method: str, *args):
    """``module.<method>(*args)`` in the module's current mode, with its
    buffers replaced by copies that are then thrown away: a train-mode
    BatchNorm normalizes with the batch's statistics as usual, but its
    running statistics keep their values (a JAX step that drops the
    ``batch_stats`` an apply returns). Gradients reach the parameters."""
    buffers = {f"module.{n}": b.clone() for n, b in module.named_buffers()}
    return functional_call(_Method(module, method), buffers, args)


OptimizerFactory = Callable[[Any], Tuple[torch.optim.Optimizer, Any]]


class Trainer:
    # a subclass whose step is not the base step's microbatch loop sets
    # this False, so that grad_accum_steps > 1 raises instead of being
    # ignored
    supports_grad_accum: bool = True

    def __init__(self, model: nn.Module, config: TrainConfig,
                 make_optimizer: Optional[OptimizerFactory] = None,
                 device="cuda", mesh: Optional[Mesh] = None):
        """``make_optimizer(params) -> (optimizer, scheduler)``, by default
        :func:`poly_sgd` at ``config.base_lr`` over
        ``config.max_iterations``. The model moves to ``device``, which is
        the card unless the caller asks for the CPU. ``mesh`` (default: all
        ranks of the process group on one ``data`` axis, one rank without
        a process group) splits each batch over its ``data`` axis; a block
        of the batch (:meth:`_blocks`) that does not split over it raises
        ``ValueError``."""
        cfg = self.config = config
        self.mesh = make_mesh() if mesh is None else mesh
        n_data = self.mesh.shape.get("data", 1)
        self._shard = (None if n_data == 1
                       else batch_sharding(self.mesh, "data"))
        k = cfg.grad_accum_steps
        if k > 1 and not self.supports_grad_accum:
            raise ValueError(f"{type(self).__name__} does not support "
                             f"grad_accum_steps > 1")
        if k < 1 or cfg.batch_size % k:
            raise ValueError(f"batch_size={cfg.batch_size} is not divisible "
                             f"by grad_accum_steps={k}")
        check_blocks(self._blocks(), n_data)
        self.device = require_device(device)
        self.model = model.to(self.device).train()
        if self._shard is not None:
            replicated(self.model, self.mesh, "data")
        if make_optimizer is None:
            def make_optimizer(params):
                return poly_sgd(params, cfg.base_lr, cfg.max_iterations)
        self.make_optimizer = make_optimizer
        self.optimizer, self.scheduler = make_optimizer(
            self.model.parameters())
        self.step = 0
        self.generator = torch.Generator(device=self.device)
        set_generator(self.model, self.generator)

    def _blocks(self) -> Tuple[int, ...]:
        """The global row counts of the blocks of the batch that one pass
        of a step sees, each of which every data rank holds a part of:
        here one microbatch."""
        return (self.config.batch_size // self.config.grad_accum_steps,)

    @property
    def group(self):
        """The process group of the data axis (None on one rank), over
        which the loss terms take their sums."""
        return None if self._shard is None else self._shard.group

    def _shard_of(self, *blocks: int) -> Optional[BatchShard]:
        """This rank's shard of a global batch made of ``blocks`` (global
        row counts; none: one block), for ``batch_shard``; None on one
        rank."""
        return None if self._shard is None else self._shard.with_blocks(
            *blocks)

    def _rows(self, x, *blocks: int):
        """This rank's rows of ``x``, whose first axis is a global batch
        made of ``blocks``; ``x`` itself on one rank."""
        shard = self._shard_of(*blocks)
        return x if shard is None else shard.rows(x)

    def _local(self, rows: int) -> int:
        """This rank's rows of a block of ``rows`` global rows."""
        return rows if self._shard is None else rows // self._shard.count

    def _adopt(self, model: nn.Module) -> nn.Module:
        """A further network of the trainer: on the device in train mode,
        with rank 0's weights on every data rank, drawing from the
        trainer's generator."""
        model = model.to(self.device).train()
        if self._shard is not None:
            replicated(model, self.mesh, "data")
        set_generator(model, self.generator)
        return model

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
        shard, group = self._shard, self.group
        self.optimizer.zero_grad(set_to_none=True)
        losses = []
        for img, lab in zip(image.chunk(k), label.chunk(k)):
            if shard is not None:  # this rank's rows of the microbatch
                img, lab = shard.rows(img), shard.rows(lab)
            with self._autocast(), batch_shard(shard):
                loss, logs = fully_supervised_loss(
                    self.model, {"image": img, "label": lab}, group)
                (loss / k).backward()
            losses.append(logs["loss_total"])
        self._reduce_grads(self.model)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss_total": torch.stack(losses).mean(),
                "lr": self.scheduler.get_last_lr()[0]}

    def _reduce_grads(self, *modules: nn.Module) -> None:
        """Data parallelism: each gradient summed over the data axis and
        divided by its size (every rank's is S times its share), in one
        flat all-reduce; nothing on one rank."""
        if self._shard is None:
            return
        grads = [p.grad for m in modules for p in m.parameters()
                 if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=self._shard.group)
        flat /= self._shard.count
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh: the rank that validates, logs scalars and
        writes checkpoints."""
        return self.mesh.rank == 0

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

    def _save_best(self, name: str, model: nn.Module, it: int) -> None:
        """Write ``model``'s best checkpoint ``name`` of step ``it``."""
        save_checkpoint(self.config.snapshot_dir, it, model.state_dict(),
                        name=name)

    def _save_periodic(self, it: int) -> None:
        """Write the periodic checkpoint of step ``it``."""
        save_checkpoint(self.config.snapshot_dir, it, self._periodic_tree())

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
    def _after_step(self, batch: Dict[str, torch.Tensor],
                    logs: Dict[str, Any]) -> None:
        """Called by :meth:`fit` after each step, before its log and eval;
        nothing here."""

    def fit(self, train_loader, val_dataset=None) -> Dict[str, Any]:
        """Train to ``max_iterations``; returns ``iterations``, ``history``
        and ``best_dice`` (``best_dice2``, ... for further models)."""
        cfg = self.config
        history = []
        it0 = self.try_resume()
        main = self.is_main
        snapshot_dir = cfg.snapshot_dir if main else None
        tb = None
        if cfg.tensorboard and snapshot_dir:
            from mamba_unet_torch.utils.experiment import TensorboardLogger

            tb = TensorboardLogger(f"{snapshot_dir}/log")
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
            self._after_step(batch, logs)
            if it % cfg.log_every == 0 or it == 1:
                loss = float(logs["loss_total"])
                log.info("iter %d loss %.4f lr %.5f (%.1f it/s)", it, loss,
                         logs["lr"], (it - it0) / (time.time() - t0))
                history.append({"iter": it, "loss": loss})
                if tb is not None:
                    tb.scalars(it, {"info/total_loss": loss,
                                    "info/lr": float(logs["lr"])})
            if main and val_dataset is not None and it % cfg.eval_every == 0:
                entry = {"iter": it}
                for name, model in self._best_models():
                    dice = self.evaluate(val_dataset, model=model)
                    log.info("iter %d val mean dice (%s) %.4f (best %.4f)",
                             it, name, dice, best[name])
                    entry["val_dice" + name[len("best"):]] = dice
                    if tb is not None:
                        tb.scalars(it, {"info/val_mean_dice"
                                        + name[len("best"):]: dice})
                    if dice > best[name]:
                        best[name] = dice
                        if snapshot_dir:
                            self._save_best(name, model, it)
                            save_best_marks(snapshot_dir, {name: dice})
                history.append(entry)
            if snapshot_dir and it % cfg.ckpt_every == 0:
                self._save_periodic(it)
        if tb is not None:
            tb.close()
        result = {"iterations": self.step, "history": history}
        result.update({"best_dice" + name[len("best"):]: value
                       for name, value in best.items()})
        return result
