"""Supervised segmentation losses, channels-last (class axis = -1).

Port of ``cross_entropy_loss``, ``dice_loss``, ``dice_loss_from_labels`` and
``supervised_ce_dice`` from ``mamba_unet_tpu/objectives/losses.py``: soft
Dice with squared-sum denominators and smooth 1e-5, per-class mean including
background; the supervised objective is 0.5 * (CE + Dice). Logits/probs are
(B, ..., C), labels integer (B, ...). Everything is computed in fp32, and a
label outside [0, C) one-hots to zeros, as ``jax.nn.one_hot`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_SMOOTH = 1e-5


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """fp32 one-hot on a new last axis; out-of-range labels give zeros."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def dice_loss(probs: torch.Tensor, target_onehot: torch.Tensor,
              weight: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-class soft dice (incl. background), weighted mean over classes.
    ``probs`` should already be softmaxed."""
    n_classes = probs.shape[-1]
    axes = tuple(range(probs.dim() - 1))
    s = probs.float()
    t = target_onehot.float()
    intersect = (s * t).sum(axes)
    denom = (s * s).sum(axes) + (t * t).sum(axes)
    per_class = 1.0 - (2.0 * intersect + _SMOOTH) / (denom + _SMOOTH)
    if weight is not None:
        per_class = per_class * torch.as_tensor(weight, dtype=torch.float32,
                                                device=per_class.device)
    return per_class.sum() / n_classes


def dice_loss_from_labels(probs: torch.Tensor, labels: torch.Tensor,
                          weight: Optional[Sequence[float]] = None
                          ) -> torch.Tensor:
    """:func:`dice_loss` against integer labels (one-hot encoded here)."""
    return dice_loss(probs, _one_hot(labels, probs.shape[-1]), weight)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross-entropy against integer labels; with
    ``ignore_index``, the mean over the other pixels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -(_one_hot(labels, logits.shape[-1]) * logp).sum(-1)
    if ignore_index is not None:
        mask = (labels != ignore_index).float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def supervised_ce_dice(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """0.5 * (CE + Dice): the supervised objective of every 2-D method."""
    ce = cross_entropy_loss(logits, labels)
    dice = dice_loss_from_labels(F.softmax(logits.float(), dim=-1), labels)
    return 0.5 * (ce + dice)
