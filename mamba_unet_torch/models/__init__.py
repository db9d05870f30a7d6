"""Models and the name registry."""

from mamba_unet_torch.models.registry import list_models, net_factory

__all__ = ["list_models", "net_factory"]
