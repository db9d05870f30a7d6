"""Serving: the predict function of a model.

Port of ``make_predict_fn`` from ``mamba_unet_tpu/utils/export.py``. It keeps
that function's ABI: (B, H, W, C) fp32 images in, (B, H, W, classes) fp32
logits out, whatever the compute dtype. Packaging with ``torch.export`` is
later work.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn


def make_predict_fn(model: nn.Module, dtype: Optional[torch.dtype] = None
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """``(B, H, W, C) fp32 -> (B, H, W, classes) fp32`` logits.

    Accepts a numpy array or a tensor and returns the same kind. Runs under
    ``torch.inference_mode()`` in eval mode on the model's device;
    ``dtype=torch.bfloat16`` runs the forward under bf16 autocast (weights
    stay fp32, the scan state stays fp32). Multi-head models give their
    main head."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported serving dtype {dtype}")
    model.eval()
    device = next(model.parameters()).device
    autocast = dtype == torch.bfloat16

    def predict(x):
        as_numpy = isinstance(x, np.ndarray)
        xt = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.inference_mode(), torch.autocast(
                device.type, torch.bfloat16, enabled=autocast):
            out = model(xt)
        out = (out[0] if isinstance(out, (tuple, list)) else out).float()
        return out.cpu().numpy() if as_numpy else out

    return predict
