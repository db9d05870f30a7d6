"""Training objectives."""

from mamba_unet_torch.objectives.losses import (
    batch_mean,
    constra_loss,
    cross_entropy_loss,
    dice_loss,
    dice_loss_from_labels,
    dice_loss_pair,
    entropy_loss,
    entropy_loss_map,
    focal_loss,
    loss_diff,
    loss_sup,
    softmax_dice_loss,
    softmax_kl_loss,
    softmax_mse_loss,
    supervised_ce_dice,
    symmetric_mse_loss,
    vat_loss,
    weighted_bce_iou_loss,
)
from mamba_unet_torch.objectives.ramps import (
    cosine_rampdown,
    linear_rampup,
    sigmoid_rampup,
)

__all__ = ["batch_mean", "constra_loss", "cosine_rampdown",
           "cross_entropy_loss", "dice_loss", "dice_loss_from_labels",
           "dice_loss_pair", "entropy_loss", "entropy_loss_map",
           "focal_loss", "linear_rampup", "loss_diff", "loss_sup",
           "sigmoid_rampup", "softmax_dice_loss", "softmax_kl_loss",
           "softmax_mse_loss", "supervised_ce_dice", "symmetric_mse_loss",
           "vat_loss", "weighted_bce_iou_loss"]
