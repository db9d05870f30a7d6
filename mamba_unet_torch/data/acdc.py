"""ACDC-format val/test volumes, read per access from h5.

Copied from ``VolumeDataset`` in ``mamba_unet_tpu/data/acdc.py``, not
imported: any import from ``mamba_unet_tpu`` runs its ``data`` package,
which imports ``jax``, and the machine that serves the port has no ``jax``.
``h5py`` is imported where a volume is read, so the port imports without it.

Layout: ``{root}/{split}.list`` holds one case id per line, each stored as
``{root}/data/{id}.h5`` with ``image`` (Z, H, W) float and ``label`` int.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class VolumeDataset:
    """Val/test dataset of 3-D volumes (read per access — they are large)."""

    def __init__(self, base_dir: str, split: str = "val"):
        if split not in ("val", "test"):
            raise ValueError(f"split must be 'val' or 'test', got {split!r}")
        self.base_dir = base_dir
        self.ids = _read_list(os.path.join(base_dir, f"{split}.list"))

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        import h5py

        path = os.path.join(self.base_dir, "data", f"{self.ids[idx]}.h5")
        with h5py.File(path, "r") as f:
            return {
                "image": np.asarray(f["image"], np.float32),
                "label": np.asarray(f["label"], np.int64),
                "case": self.ids[idx],
            }
