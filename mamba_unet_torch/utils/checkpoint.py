"""Checkpoints and model snapshots.

Port of ``save_checkpoint``, ``latest_step``, ``restore_checkpoint``,
``save_best_marks``, ``load_best_marks``, ``save_cta_state``,
``load_cta_state`` and ``load_model_snapshot`` from
``mamba_unet_tpu/utils/checkpoint.py``. Where the JAX package writes an
orbax directory, the port writes one ``torch.save`` file, under the same
``{directory}/{name}_{step}`` name, and reads it back with
``torch.load(weights_only=True)``. The trainer saves a model's
``state_dict`` as ``best_{step}`` (so the test CLI's ``--checkpoint`` loads
it as it is) and ``{"model", "optimizer", "scheduler", "step"}`` as the
periodic ``state_{step}`` it resumes from.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from mamba_unet_torch.utils.device import require_device


def save_checkpoint(directory: str, step: int, tree: Any,
                    name: str = "state") -> str:
    """Save ``tree`` as {directory}/{name}_{step}, atomically (write to a
    temporary name, then rename). Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"{name}_{step}"))
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str, name: str = "state") -> Optional[int]:
    """The largest step of a {name}_{step} entry in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for entry in os.listdir(directory):
        if entry.startswith(f"{name}_"):
            try:
                steps.append(int(entry.rsplit("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, name: str = "state",
                       map_location=None) -> Any:
    """Load the tree saved as {directory}/{name}_{step}."""
    path = os.path.abspath(os.path.join(directory, f"{name}_{step}"))
    return torch.load(path, map_location=map_location, weights_only=True)


_BEST_MARKS_FILE = "best_marks.json"


def save_best_marks(directory: str, marks: Dict[str, float]) -> str:
    """Merge ``marks`` into {directory}/best_marks.json, atomically.

    The sidecar keeps each best-metric high-water mark (keyed by the best
    checkpoint's name) across kill-and-resume, so a resumed run cannot
    overwrite a better ``best_*`` checkpoint."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _BEST_MARKS_FILE)
    merged = load_best_marks(directory)
    merged.update({k: float(v) for k, v in marks.items()})
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_best_marks(directory: str) -> Dict[str, float]:
    """Read the best-marks sidecar; {} when absent or unreadable."""
    path = os.path.join(directory, _BEST_MARKS_FILE)
    try:
        with open(path) as f:
            got = json.load(f)
        return {str(k): float(v) for k, v in got.items()}
    except (OSError, ValueError, TypeError, AttributeError):
        # TypeError: non-numeric values; AttributeError: the top level is
        # not an object. Both count as unreadable.
        return {}


_CTA_STATE_FILE = "cta_state.json"


def save_cta_state(directory: str, cta) -> str:
    """Write a CTAugment policy's learned state (depth, th, decay and the
    per-op bin rates) to {directory}/cta_state.json, atomically: the same
    JSON file as the JAX package writes. A resumed contrastive run without
    it would forget every learned augmentation rate."""
    import numpy as np

    os.makedirs(directory, exist_ok=True)
    sd = cta.state_dict()
    payload = {
        "depth": int(sd["depth"]),
        "th": float(sd["th"]),
        "decay": float(sd["decay"]),
        "rates": {k: [np.asarray(r).tolist() for r in bins]
                  for k, bins in sd["rates"].items()},
    }
    path = os.path.join(directory, _CTA_STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_cta_state(directory: str, cta) -> bool:
    """Restore a policy written by :func:`save_cta_state` into ``cta``;
    True when the file was there."""
    import numpy as np

    path = os.path.join(directory, _CTA_STATE_FILE)
    try:
        with open(path) as f:
            payload = json.load(f)
    except OSError:
        return False
    cta.load_state_dict({
        "depth": int(payload["depth"]),
        "th": float(payload["th"]),
        "decay": float(payload["decay"]),
        "rates": {k: tuple(np.asarray(r, dtype="f") for r in bins)
                  for k, bins in payload["rates"].items()},
    })
    return True


def load_model_snapshot(
    name: str,
    num_classes: int,
    in_ch: int,
    path: Optional[str] = None,
    device="cuda",
    ckpt_name: Optional[str] = None,
    **model_kw,
) -> nn.Module:
    """Build ``name`` via ``net_factory`` in eval mode on ``device``: the
    card unless the caller asks for the CPU (raises when CUDA is asked for
    and not available).

    ``path=None`` keeps the initialization drawn from a generator seeded
    with 0. A file ``path`` is a saved ``state_dict``. A directory ``path``
    is a training ``--snapshot_dir``: the newest ``{ckpt_name}_{step}``
    (multi-model trainers save ``best``/``best2``/``best3``); without
    ``ckpt_name`` the newest ``best_{step}``, or else the ``"model"`` entry
    of the newest periodic ``state_{step}``. The weights load strictly, a
    BatchNorm's running statistics with them. ``model_kw`` goes to
    ``net_factory`` (``img_size`` for ``ViT_seg``). bf16 serving is chosen
    later, in ``make_predict_fn``: the weights stay fp32."""
    from mamba_unet_torch.models import net_factory  # lazy: avoid a cycle

    device = require_device(device)
    model = net_factory(name, num_classes=num_classes, in_chans=in_ch,
                        device=device,
                        generator=torch.Generator().manual_seed(0),
                        **model_kw)
    if path:
        model.load_state_dict(_snapshot_state(path, ckpt_name, device))
    return model.eval()


def _snapshot_state(path: str, ckpt_name: Optional[str], device):
    """The ``state_dict`` that :func:`load_model_snapshot` loads from
    ``path``."""
    if not os.path.isdir(path):
        return torch.load(path, map_location=device, weights_only=True)
    name = ckpt_name or "best"
    step = latest_step(path, name)
    if step is not None:
        return restore_checkpoint(path, step, name, map_location=device)
    step = None if ckpt_name else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no {name!r} checkpoint under {path}")
    return restore_checkpoint(path, step, map_location=device)["model"]
