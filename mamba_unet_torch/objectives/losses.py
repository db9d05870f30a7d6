"""Segmentation and consistency losses, channels-last (class axis = -1).

Port of ``cross_entropy_loss``, ``dice_loss``, ``dice_loss_from_labels``,
``supervised_ce_dice``, ``dice_loss_pair``, ``softmax_dice_loss``, the
consistency losses (``softmax_mse_loss``, ``softmax_kl_loss``,
``symmetric_mse_loss``), ``entropy_loss``/``entropy_loss_map`` and
Semi-Mamba-UNet's ``constra_loss`` from
``mamba_unet_tpu/objectives/losses.py``, and the losses that module
exports but no trainer calls (``vat_loss``, ``weighted_bce_iou_loss``,
``loss_sup``, ``loss_diff``, ``focal_loss``): soft Dice with squared-sum
denominators and smooth 1e-5, per-class mean including background; the
supervised objective is 0.5 * (CE + Dice). Logits/probs are (B, ..., C),
labels integer (B, ...). The supervised losses and the Dice and
contrastive terms are computed in fp32, and a label outside [0, C)
one-hots to zeros, as ``jax.nn.one_hot`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

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


# --- exported, called by no trainer -----------------------------------------

def _main_head(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _l2_normalize_per_sample(d: torch.Tensor) -> torch.Tensor:
    """Each sample's whole perturbation scaled to unit norm (+1e-8)."""
    norm = d.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (d.dim() - 1))
    return d / (norm + 1e-8)


def vat_loss(forward_fn: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor, generator: Optional[torch.Generator] = None,
             xi: float = 10.0, epi: float = 6.0, ip: int = 1,
             d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Virtual adversarial training loss: the soft Dice between the clean
    softmax (no gradient) and the softmax at ``x + epi * d``, where ``d``
    is found by ``ip`` power iterations, each the normalised gradient
    (``torch.autograd.grad``, its graph kept, as ``jax.grad`` in the JAX
    function is differentiated through) of the same Dice at ``x + xi * d``
    with respect to ``d``. ``forward_fn(x)`` gives logits (the main head
    of a tuple). The first direction is ``d`` when given, else uniform in
    [-0.5, 0.5) drawn from ``generator``; it is normalised per sample."""
    with torch.no_grad():
        pred = F.softmax(_main_head(forward_fn(x)).float(), dim=-1)
    if d is None:
        d = torch.rand(x.shape, generator=generator, device=x.device) - 0.5
    d = _l2_normalize_per_sample(d.float())
    with torch.enable_grad():
        for _ in range(ip):
            if not d.requires_grad:
                d = d.detach().requires_grad_(True)
            p_hat = F.softmax(_main_head(forward_fn(x + xi * d)).float(),
                              dim=-1)
            (grad,) = torch.autograd.grad(dice_loss(p_hat, pred), d,
                                          create_graph=True)
            d = _l2_normalize_per_sample(grad)
    p_hat = F.softmax(_main_head(forward_fn(x + epi * d)).float(), dim=-1)
    return dice_loss(p_hat, pred)


def _box_mean_2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Same-padded k x k box mean over (B, H, W), dividing by k * k
    everywhere (the padding's zeros count)."""
    return F.avg_pool2d(x[:, None], k, stride=1, padding=k // 2,
                        count_include_pad=True)[:, 0]


def weighted_bce_iou_loss(pred: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    """Boundary-weighted BCE + weighted IoU of (B, H, W) probabilities
    against a mask: weight 1 + 5 |boxmean31(mask) - mask|; the BCE clips
    ``pred`` to [1e-7, 1 - 1e-7]."""
    pred, mask = pred.float(), mask.float()
    weit = 1.0 + 5.0 * (_box_mean_2d(mask, 31) - mask).abs()
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    wbce = -(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))
    wbce = (weit * wbce).sum((1, 2)) / weit.sum((1, 2))
    inter = (pred * mask * weit).sum((1, 2))
    union = ((pred + mask) * weit).sum((1, 2))
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


def loss_sup(logit_s1: torch.Tensor, logit_s2: torch.Tensor,
             labels_s1: torch.Tensor, labels_s2: torch.Tensor
             ) -> torch.Tensor:
    """Two branches' :func:`weighted_bce_iou_loss`, summed."""
    return (weighted_bce_iou_loss(logit_s1, labels_s1)
            + weighted_bce_iou_loss(logit_s2, labels_s2))


def loss_diff(u_pred_1: torch.Tensor, u_pred_2: torch.Tensor
              ) -> torch.Tensor:
    """Each branch's :func:`weighted_bce_iou_loss` against the other's
    prediction, summed, with no gradient (a value only)."""
    with torch.no_grad():
        return (weighted_bce_iou_loss(u_pred_1, u_pred_2)
                + weighted_bce_iou_loss(u_pred_2, u_pred_1))


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0, alpha: Optional[Sequence[float]] = None
               ) -> torch.Tensor:
    """Multiclass focal loss, the mean of -alpha_t (1 - p_t)^gamma
    log p_t (alpha_t = 1 without ``alpha``)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    logpt = (_one_hot(labels, logits.shape[-1]) * logp).sum(-1)
    loss = -((1.0 - logpt.exp()) ** gamma) * logpt
    if alpha is not None:
        loss = loss * torch.as_tensor(alpha, dtype=torch.float32,
                                      device=loss.device)[labels.long()]
    return loss.mean()
