"""Training: the trainer, the semi-supervised methods, the scribble-
supervised Weak-Mamba-UNet and the optimizers."""

from mamba_unet_torch.train.methods import (
    CrossTeachingTrainer,
    MeanTeacherTrainer,
    UAMTTrainer,
    build_semi_method,
    rampup_weight,
)
from mamba_unet_torch.train.optim import poly_lr, poly_sgd, warmup_adamw
from mamba_unet_torch.train.state import ema_update
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    fully_supervised_loss,
)
from mamba_unet_torch.train.weak import WeakScribbleTrainer

__all__ = ["CrossTeachingTrainer", "MeanTeacherTrainer", "TrainConfig",
           "Trainer", "UAMTTrainer", "WeakScribbleTrainer",
           "build_semi_method", "ema_update", "fully_supervised_loss",
           "poly_lr", "poly_sgd", "rampup_weight", "warmup_adamw"]
