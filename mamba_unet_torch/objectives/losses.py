"""Segmentation and consistency losses, channels-last (class axis = -1).

Port of ``cross_entropy_loss``, ``dice_loss``, ``dice_loss_from_labels``,
``supervised_ce_dice``, ``dice_loss_pair``, ``softmax_dice_loss``, the
consistency losses (``softmax_mse_loss``, ``softmax_kl_loss``,
``symmetric_mse_loss``), ``entropy_loss``/``entropy_loss_map`` and
Semi-Mamba-UNet's ``constra_loss`` from
``mamba_unet_tpu/objectives/losses.py``: soft Dice with squared-sum
denominators and smooth 1e-5, per-class mean including background; the
supervised objective is 0.5 * (CE + Dice). Logits/probs are (B, ..., C),
labels integer (B, ...). The supervised losses and the Dice and
contrastive terms are computed in fp32, and a label outside [0, C)
one-hots to zeros, as ``jax.nn.one_hot`` does.
"""

from __future__ import annotations

import math
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


def dice_loss_pair(score: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Soft Dice on raw tensors with a linear denominator (global sums)."""
    score, target = score.float(), target.float()
    intersect = (score * target).sum()
    denom = score.sum() + target.sum()
    return 1.0 - (2.0 * intersect + _SMOOTH) / (denom + _SMOOTH)


def softmax_dice_loss(input_logits: torch.Tensor,
                      target_logits: torch.Tensor) -> torch.Tensor:
    """Per-class :func:`dice_loss_pair` between the two softmaxes, mean over
    classes."""
    p = F.softmax(input_logits.float(), dim=-1)
    q = F.softmax(target_logits.float(), dim=-1)
    axes = tuple(range(p.dim() - 1))
    intersect = (p * q).sum(axes)
    denom = p.sum(axes) + q.sum(axes)
    return (1.0 - (2.0 * intersect + _SMOOTH) / (denom + _SMOOTH)).mean()


def softmax_mse_loss(input_logits: torch.Tensor,
                     target_logits: torch.Tensor) -> torch.Tensor:
    """Elementwise (softmax(in) - softmax(target))², not reduced."""
    return (F.softmax(input_logits, dim=-1)
            - F.softmax(target_logits, dim=-1)) ** 2


def softmax_kl_loss(input_logits: torch.Tensor,
                    target_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(target) || softmax(in)), the integrand averaged over all
    elements, the class axis included."""
    logp = F.log_softmax(input_logits, dim=-1)
    q = F.softmax(target_logits, dim=-1)
    return (q * (torch.log(q.clamp(min=1e-30)) - logp)).mean()


def symmetric_mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def entropy_loss_map(p: torch.Tensor, num_classes: Optional[int] = None
                     ) -> torch.Tensor:
    """Per-pixel entropy of probability maps over ln(C), class axis kept."""
    c = num_classes or p.shape[-1]
    return -(p * torch.log(p + 1e-6)).sum(-1, keepdim=True) / math.log(c)


def entropy_loss(p: torch.Tensor, num_classes: Optional[int] = None
                 ) -> torch.Tensor:
    """Mean of :func:`entropy_loss_map`."""
    return entropy_loss_map(p, num_classes).mean()


def constra_loss(inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Semi-Mamba-UNet's contrastive term: each model's (B, H, W, C) logits
    average-pooled to a per-sample channel vector, L2-normalised, then the
    mean squared difference."""
    a = inputs.float().mean(dim=(1, 2))
    b = targets.float().mean(dim=(1, 2))
    a = a / a.norm(dim=1, keepdim=True).clamp(min=1e-12)
    b = b / b.norm(dim=1, keepdim=True).clamp(min=1e-12)
    return ((a - b) ** 2).mean()
