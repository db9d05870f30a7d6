"""Model registry: build a model by the name the reference scripts use.

Port of ``mamba_unet_tpu/models/registry.py``. Models are resolved lazily,
so importing the registry does not import the model zoo.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from torch import nn

# name -> (module path, class name)
_LAZY: Dict[str, Tuple[str, str]] = {
    "ViM_seg": ("mamba_unet_torch.models.vssm", "MambaUnet"),
    "mambaunet": ("mamba_unet_torch.models.vssm", "MambaUnet"),
}


def list_models():
    return sorted(_LAZY)


def net_factory(net_type: str, **kwargs) -> nn.Module:
    """Build a model by registry name with keyword overrides (``device``,
    ``generator``, ``num_classes``, ``scan_impl``, ``use_remat``, ...)."""
    if net_type not in _LAZY:
        raise KeyError(f"unknown model {net_type!r}; known: {list_models()}")
    module, attr = _LAZY[net_type]
    return getattr(importlib.import_module(module), attr)(**kwargs)
