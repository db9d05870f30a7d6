"""Experiment infrastructure: snapshot dirs, code archive, ``log.txt``,
``label2color`` and the scalar logger.

Port of ``mamba_unet_tpu/utils/experiment.py``:

  * snapshot dir "../model/{exp}_{labeled_num}_labeled/{model}" with a
    copy of the package's source (this package, ``mamba_unet_torch``);
  * logging to snapshot/log.txt and stdout with ms timestamps;
  * :class:`TensorboardLogger`: scalars and the x50-grey image triplet.

The JAX logger writes through ``tensorboardX`` and writes nothing where it
is missing. This one takes ``tensorboardX``, else PyTorch's
``torch.utils.tensorboard`` (which needs the ``tensorboard`` package), and
always also appends every scalar to ``scalars.jsonl`` in the log dir (one
JSON object per call: ``{"step": N, "tag": value, ...}``), so a machine
with neither package still keeps its scalars.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import sys
from typing import Dict, Optional

import numpy as np

# RGB palette for label2color (utils/utils.py:87-92 of the reference)
_PALETTE = np.asarray(
    [[0, 0, 0], [220, 20, 60], [0, 128, 0], [30, 144, 255], [255, 215, 0],
     [138, 43, 226], [255, 140, 0], [0, 206, 209], [128, 128, 0],
     [199, 21, 133], [70, 130, 180], [154, 205, 50], [205, 92, 92],
     [75, 0, 130]], np.uint8,
)
SCALARS_FILE = "scalars.jsonl"


def snapshot_path(exp: str, labeled_num: Optional[int], model: str,
                  root: str = "../model") -> str:
    tag = f"{exp}_{labeled_num}_labeled" if labeled_num is not None else exp
    return os.path.join(root, tag, model)


def setup_experiment(snapshot_dir: str, archive_code: bool = True) -> None:
    """Create the snapshot dir, archive this package's source (once), and
    log to ``log.txt`` there and to stdout."""
    os.makedirs(snapshot_dir, exist_ok=True)
    if archive_code:
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(snapshot_dir, "code")
        if not os.path.exists(dst):
            shutil.copytree(
                src, dst,
                ignore=shutil.ignore_patterns("__pycache__", "*.pyc"),
            )
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S",
        handlers=[
            logging.FileHandler(os.path.join(snapshot_dir, "log.txt")),
            logging.StreamHandler(sys.stdout),
        ],
        force=True,
    )


def label2color(label: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 RGB."""
    return _PALETTE[np.clip(label, 0, len(_PALETTE) - 1)]


def _summary_writer(log_dir: str):
    """A tensorboard ``SummaryWriter`` (tensorboardX's, else PyTorch's), or
    None where neither package is installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter(log_dir)


class TensorboardLogger:
    """Scalars and images into ``log_dir``: a tensorboard event file where
    a writer is installed, and the scalars always also into
    ``log_dir/scalars.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.writer = _summary_writer(log_dir)
        self.path = os.path.join(log_dir, SCALARS_FILE)
        self._file = open(self.path, "a")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        values = {k: float(v) for k, v in values.items()}
        self._file.write(json.dumps({"step": int(step), **values}) + "\n")
        self._file.flush()
        if self.writer is not None:
            for k, v in values.items():
                self.writer.add_scalar(k, v, step)

    def image_triplet(self, step: int, image: np.ndarray, pred: np.ndarray,
                      label: np.ndarray) -> None:
        """input / prediction / GT images; predictions use the reference's
        x50 grey-scaling trick for visibility (event file only)."""
        if self.writer is None:
            return
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[..., 0]
        self.writer.add_image("train/Image", img[None], step)
        self.writer.add_image("train/Prediction",
                              (np.asarray(pred) * 50).astype(np.uint8)[None],
                              step)
        self.writer.add_image("train/GroundTruth",
                              (np.asarray(label) * 50).astype(np.uint8)[None],
                              step)

    def close(self) -> None:
        self._file.close()
        if self.writer is not None:
            self.writer.close()


def read_scalars(log_dir: str) -> list:
    """The records of ``log_dir/scalars.jsonl``, in order."""
    with open(os.path.join(log_dir, SCALARS_FILE)) as f:
        return [json.loads(line) for line in f if line.strip()]
