"""The device an entry point runs on."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``torch.device(device)``; raise for a CUDA device when CUDA is not
    available, rather than run anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() is "
            f"false; pass device 'cpu' to run on the CPU")
    return dev
