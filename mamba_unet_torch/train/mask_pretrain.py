"""Self-supervised mask pretraining: shuffled + masked recovery + location.

Port of ``mamba_unet_tpu/train/mask_pretrain.py``
(``MaskPretrainTrainer``), for a model with the mask heads
(``MambaUnetMask``). No label is read. Per step, on the batch's images:

* the clean, the cube-shuffled (with its shuffle ids) and the cube-masked
  (with its visibility mask) image through ``forward_mix_pos_mask`` in
  train mode; the shuffled and the masked recovery are the MSEs between
  the clean global embedding and the other two;
* the cube-location task: every ``cube_size`` cube of the batch through
  ``forward_encoder`` in eval mode (the position embedding's BatchNorm
  normalizing with the running statistics from before the step, no
  drop-path; gradients still flow, so SS2D runs its training kernels),
  its flattened bottleneck through ``forward_location`` in train mode, and
  the cross-entropy against the cube's location;
* loss = shuffled + masked + ``loc_weight`` (0.1) x location.

The model keeps the BatchNorm statistics of the clean pass only; the
other passes' are thrown away, as the JAX step keeps only the clean head's
``batch_stats``. A parameter the loss does not reach (the prediction
conv) still decays, as in the JAX step. The shuffle ids draw from stream
0 of the step's seed, the visibility mask from stream 1 and the three
heads' drop-path from stream 2, the same for each head (the JAX step's
r_shuf, r_mask and r_bn).

Over a data axis of S ranks each rank holds B / S images and their
cubes; the draws are made for the global batch, and the MSEs' and the
location cross-entropy's sums taken over the ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from mamba_unet_torch.objectives import cross_entropy_loss
from mamba_unet_torch.objectives.cube import (
    get_patch_list,
    random_permutations,
)
from mamba_unet_torch.objectives.masked import (
    make_masked_input,
    make_shuffled_input,
    recovery_mse,
)
from mamba_unet_torch.parallel.comm import batch_shard
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    call_discarding_stats,
    zero_unreached_grads,
)

SHUFFLE, MASK, HEADS = range(3)  # the generator's streams in a step
MASK_MODEL_METHODS = ("forward_mix_pos_mask", "forward_encoder",
                      "forward_location")


class MaskPretrainTrainer(Trainer):
    supports_grad_accum = False

    def __init__(self, model: nn.Module, config: TrainConfig,
                 cube_size: int = 32, masked_rate: float = 0.25,
                 loc_weight: float = 0.1, **kw):
        """``kw`` goes to :class:`Trainer` (``make_optimizer``,
        ``device``)."""
        missing = [m for m in MASK_MODEL_METHODS if not hasattr(model, m)]
        if missing:
            raise ValueError(f"mask pretraining needs a model with the mask "
                             f"heads (MambaUnetMask); "
                             f"{type(model).__name__} has no {missing}")
        self.cube_size = cube_size
        self.masked_rate = masked_rate
        self.loc_weight = loc_weight
        super().__init__(model, config, **kw)

    def _draws(self, image: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(shuffle ids, visibility mask), both (B, cubes)."""
        b = image.shape[0]
        cubes = (image.shape[1] // self.cube_size) ** 2
        self._reseed(SHUFFLE)
        perms = random_permutations(self.generator, b, cubes, image.device)
        self._reseed(MASK)
        vis = (torch.rand(b, cubes, generator=self.generator,
                          device=image.device) > self.masked_rate).float()
        return perms, vis

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        model, g = self.model, self.group
        image = batch["image"].to(self.device, non_blocking=True).float()
        n = image.shape[0]
        perms, vis = self._draws(image)
        shuffled, _ = make_shuffled_input(image, self.cube_size, perms=perms)
        masked, _ = make_masked_input(image, self.cube_size,
                                      self.masked_rate, vis=vis)
        image, shuffled, masked, perms, vis = (
            self._rows(t, n) for t in (image, shuffled, masked, perms, vis))
        b = image.shape[0]  # this rank's
        shard = self._shard_of(n)
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with self._autocast(), batch_shard(shard):
            # the location pass first: its eval-mode BatchNorm normalizes
            # with the running statistics from before the clean pass
            patches = get_patch_list(image, self.cube_size)
            cubes = patches.shape[1]
            model.eval()  # deterministic; the grad mode is untouched
            try:
                feats = call_discarding_stats(
                    model, "forward_encoder",
                    patches.reshape(b * cubes, *patches.shape[2:]))
            finally:
                model.train()
            self._reseed(HEADS)
            with batch_shard(None if shard is None else shard.scaled(cubes)):
                loc_logits = call_discarding_stats(
                    model, "forward_location",
                    feats[-1].reshape(b * cubes, -1))
            self._reseed(HEADS)
            clean = model.forward_mix_pos_mask(image)
            self._reseed(HEADS)
            shuf_out = call_discarding_stats(model, "forward_mix_pos_mask",
                                             shuffled, perms.float())
            self._reseed(HEADS)
            mask_out = call_discarding_stats(model, "forward_mix_pos_mask",
                                             masked, None, vis)
        shuffled_loss = recovery_mse(clean, shuf_out, g)
        mask_loss = recovery_mse(clean, mask_out, g)
        loc = cross_entropy_loss(
            loc_logits.float(),
            torch.arange(cubes, device=self.device).repeat(b), group=g)
        total = shuffled_loss + mask_loss + self.loc_weight * loc
        total.backward()
        zero_unreached_grads(model)
        self._reduce_grads(model)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss_total": total.detach(),
                "loss_shuffled": shuffled_loss.detach(),
                "loss_mask": mask_loss.detach(), "loss_loc": loc.detach(),
                "lr": self.scheduler.get_last_lr()[0]}
