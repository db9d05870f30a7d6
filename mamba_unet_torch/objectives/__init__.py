"""Training objectives."""

from mamba_unet_torch.objectives.losses import (
    cross_entropy_loss,
    dice_loss,
    dice_loss_from_labels,
    supervised_ce_dice,
)

__all__ = ["cross_entropy_loss", "dice_loss", "dice_loss_from_labels",
           "supervised_ce_dice"]
