"""Model registry: build a model by the name the reference scripts use.

Port of ``mamba_unet_tpu/models/registry.py``, with every name of it
(``SwinUNETR`` also as ``swinunetr``). Models are resolved lazily, so
importing the registry does not import the model zoo.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from torch import nn

# name -> (module path, class name)
_LAZY: Dict[str, Tuple[str, str]] = {
    "ViM_seg": ("mamba_unet_torch.models.vssm", "MambaUnet"),
    "mambaunet": ("mamba_unet_torch.models.vssm", "MambaUnet"),
    "unet": ("mamba_unet_torch.models.unet", "UNet"),
    "unet_ds": ("mamba_unet_torch.models.unet", "UNetDS"),
    "unet_urpc": ("mamba_unet_torch.models.unet", "UNetURPC"),
    "unet_cct": ("mamba_unet_torch.models.unet", "UNetCCT"),
    "TLunet": ("mamba_unet_torch.models.unet", "TLUNet"),
    "ViT_seg": ("mamba_unet_torch.models.swin_unet", "SwinUnet"),
    "MambaUnetMask": ("mamba_unet_torch.models.mamba_mask", "MambaUnetMask"),
    "projector": ("mamba_unet_torch.models.small_nets", "Projectors"),
    "classifier": ("mamba_unet_torch.models.small_nets", "Classifier"),
    "Jigsaw_classifier": ("mamba_unet_torch.models.small_nets",
                          "JigsawClassifier"),
    "pnet": ("mamba_unet_torch.models.small_nets", "PNet2D"),
    "vnet": ("mamba_unet_torch.models.vnet", "vnet_2d"),
    "vnet_3D": ("mamba_unet_torch.models.vnet", "vnet_3d"),
    "magicnet": ("mamba_unet_torch.models.vnet", "magicnet_3d"),
    "magicnet_2D": ("mamba_unet_torch.models.vnet", "magicnet_2d"),
    "magicnet_2D_mask": ("mamba_unet_torch.models.magicnet_mask",
                         "VNetMagicMask"),
    "enet": ("mamba_unet_torch.models.enet", "ENet"),
    "fc_discriminator": ("mamba_unet_torch.models.misc_nets",
                         "fc_discriminator"),
    "fc3d_discriminator": ("mamba_unet_torch.models.misc_nets",
                           "fc3d_discriminator"),
    "preUnet": ("mamba_unet_torch.models.misc_nets", "PreUNet"),
    "efficient_unet": ("mamba_unet_torch.models.misc_nets", "EffiUNet"),
    "unet_3D": ("mamba_unet_torch.models.unet_3d", "UNet3D"),
    "unet_3D_dv_semi": ("mamba_unet_torch.models.unet_3d", "UNet3DDVSemi"),
    "voxresnet": ("mamba_unet_torch.models.unet_3d", "VoxResNet"),
    "attention_unet": ("mamba_unet_torch.models.attention_unet",
                       "AttentionUNet3D"),
    "nnUNet": ("mamba_unet_torch.models.nnunet", "GenericUNet"),
    "unetr": ("mamba_unet_torch.models.unetr", "UNETR"),
    "SwinUNETR": ("mamba_unet_torch.models.swin_unetr", "SwinUNETR"),
    "swinunetr": ("mamba_unet_torch.models.swin_unetr", "SwinUNETR"),
    "segmamba": ("mamba_unet_torch.models.segmamba", "SegMamba"),
}
# the models that take a scan_impl (SS2D's branches; SegMamba's 1-D Mamba
# has one route, the grouped kernels), those with stochastic depth,
# those built for one input size (img_size), those built for a cube size
# and a patch size (cube_size, patch_size: MagicNet's location and mask
# heads), and the 3-D ones
SCAN_MODELS = frozenset({"ViM_seg", "mambaunet", "MambaUnetMask"})
DROP_PATH_MODELS = frozenset({"ViM_seg", "mambaunet", "ViT_seg",
                              "MambaUnetMask"})
IMG_SIZE_MODELS = frozenset({"ViT_seg", "MambaUnetMask", "unetr",
                             "SwinUNETR", "swinunetr"})
CUBE_MODELS = frozenset({"MambaUnetMask", "magicnet", "magicnet_2D",
                         "magicnet_2D_mask"})
VOLUME_MODELS = frozenset({"vnet_3D", "magicnet", "unet_3D",
                           "unet_3D_dv_semi", "voxresnet", "attention_unet",
                           "nnUNet", "unetr", "SwinUNETR", "swinunetr",
                           "segmamba", "fc3d_discriminator"})


def size_kwargs(net_type: str, patch_size: int, cube_size: int = 32
                ) -> dict:
    """The keywords that build ``net_type`` for images of side
    ``patch_size`` (and cubes of ``cube_size``): ``img_size`` for
    :data:`IMG_SIZE_MODELS`, ``cube_size`` and ``patch_size`` for
    :data:`CUBE_MODELS`, none for the others."""
    kw = {}
    if net_type in IMG_SIZE_MODELS:
        kw["img_size"] = patch_size
    if net_type in CUBE_MODELS:
        kw.update(cube_size=cube_size, patch_size=patch_size)
    return kw


def list_models():
    return sorted(_LAZY)


def net_factory(net_type: str, **kwargs) -> nn.Module:
    """Build a model by registry name with keyword overrides (``device``,
    ``generator``, ``num_classes``, ``in_chans``; ``scan_impl`` and
    ``use_remat`` for the Mamba models, ``drop_path_rate`` for those in
    :data:`DROP_PATH_MODELS`, ``img_size`` for those in
    :data:`IMG_SIZE_MODELS`, ``cube_size`` and ``patch_size`` for those in
    :data:`CUBE_MODELS`, ...)."""
    if net_type not in _LAZY:
        raise KeyError(f"unknown model {net_type!r}; known: {list_models()}")
    module, attr = _LAZY[net_type]
    return getattr(importlib.import_module(module), attr)(**kwargs)
