"""ACDC-format datasets: train slices (cached) and val/test volumes, from h5.

Copied from ``SliceDataset``, ``VolumeDataset`` and ``patients_to_slices``
in ``mamba_unet_tpu/data/acdc.py``, not imported: any import from
``mamba_unet_tpu`` runs its ``data`` package, which imports ``jax``, and the
machine that runs the port has no ``jax``. ``h5py`` is imported where a
file is read, so the port imports without it.

Layout::

    {root}/train_slices.list  one slice id per line -> {root}/data/slices/{id}.h5
    {root}/{split}.list       one case id per line  -> {root}/data/{id}.h5

with ``image`` (float) and ``label`` (int): (H, W) per train slice,
(Z, H, W) per val/test volume.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

# Labeled-subset table: patients -> slices (the reference's utils.py)
_ACDC_PATIENTS_TO_SLICES = {
    1: 14, 2: 28, 3: 68, 7: 136, 14: 256, 21: 396, 28: 512, 35: 664, 140: 1312,
}


def patients_to_slices(dataset: str, patients_num: int) -> int:
    if "ACDC" in dataset:
        return _ACDC_PATIENTS_TO_SLICES[int(patients_num)]
    raise KeyError(f"no labeled-subset table for dataset {dataset!r}")


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


class SliceDataset:
    """Training dataset of 2-D slices, cached in RAM when ``cache``.

    ``sup_type`` names the h5 key served as the label (``"scribble"`` for
    sparse annotation)."""

    def __init__(self, base_dir: str, num: Optional[int] = None,
                 transform=None, cache: bool = True,
                 sup_type: str = "label"):
        self.base_dir = base_dir
        self.transform = transform
        self.sup_type = sup_type
        self.ids = _read_list(os.path.join(base_dir, "train_slices.list"))
        if num is not None:
            self.ids = self.ids[:num]
        self._cache: Optional[List[Dict[str, np.ndarray]]] = None
        if cache:
            self._cache = [self._load(i) for i in range(len(self.ids))]

    @classmethod
    def from_samples(cls, samples, transform=None) -> "SliceDataset":
        """A dataset over in-memory ``{"image", "label"}`` slices (e.g.
        ``data.synthetic.phantom_acdc``), read as the h5 ones are."""
        ds = cls.__new__(cls)
        ds.base_dir, ds.transform, ds.sup_type = None, transform, "label"
        ds.ids = [str(i) for i in range(len(samples))]
        ds._cache = [{"image": np.asarray(s["image"], np.float32),
                      "label": np.asarray(s["label"], np.int64)}
                     for s in samples]
        return ds

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        import h5py

        path = os.path.join(self.base_dir, "data", "slices",
                            f"{self.ids[idx]}.h5")
        with h5py.File(path, "r") as f:
            return {
                "image": np.asarray(f["image"], np.float32),
                "label": np.asarray(f[self.sup_type], np.int64),
            }

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = (self._cache[idx] if self._cache is not None
                  else self._load(idx))
        sample = {"image": sample["image"], "label": sample["label"]}
        if self.transform is not None:
            sample = self.transform(sample)
        sample["idx"] = idx
        return sample


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
