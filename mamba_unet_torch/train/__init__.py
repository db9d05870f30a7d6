"""Training: the trainer and its optimizers."""

from mamba_unet_torch.train.optim import poly_lr, poly_sgd, warmup_adamw
from mamba_unet_torch.train.trainer import (
    TrainConfig,
    Trainer,
    fully_supervised_loss,
)

__all__ = ["TrainConfig", "Trainer", "fully_supervised_loss", "poly_lr",
           "poly_sgd", "warmup_adamw"]
