"""Model snapshots: build a net by name and load its weights.

Port of ``load_model_snapshot`` from ``mamba_unet_tpu/utils/checkpoint.py``
(the shared load of the test CLI and serving). Where the JAX package restores
an orbax directory, the port loads a ``torch.save``d ``state_dict``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def load_model_snapshot(
    name: str,
    num_classes: int,
    in_ch: int,
    path: Optional[str] = None,
    device="cpu",
) -> nn.Module:
    """Build ``name`` via ``net_factory`` in eval mode on ``device``.

    ``path=None`` keeps the initialization drawn from a generator seeded
    with 0; otherwise the ``state_dict`` saved at ``path`` is loaded
    strictly. bf16 serving is chosen later, in ``make_predict_fn``: the
    weights stay fp32."""
    from mamba_unet_torch.models import net_factory  # lazy: avoid a cycle

    model = net_factory(name, num_classes=num_classes, in_chans=in_ch,
                        device=device,
                        generator=torch.Generator().manual_seed(0))
    if path:
        state = torch.load(path, map_location=device, weights_only=True)
        model.load_state_dict(state)
    return model.eval()
