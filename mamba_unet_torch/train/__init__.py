"""Training: the trainer, the semi-supervised methods and the optimizers."""

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

__all__ = ["CrossTeachingTrainer", "MeanTeacherTrainer", "TrainConfig",
           "Trainer", "UAMTTrainer", "build_semi_method", "ema_update",
           "fully_supervised_loss", "poly_lr", "poly_sgd", "rampup_weight",
           "warmup_adamw"]
