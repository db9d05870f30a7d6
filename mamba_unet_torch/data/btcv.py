"""BTCV-style 3-D volumes: the training dataset, its 3-D transforms and
the synthetic h5 writer.

Port of ``mamba_unet_tpu/data/btcv.py`` (the reconstruction of the
reference's missing ``BTCV`` dataset from the 3-D MagicNet script's use of
it): ``VolumeTrainDataset`` reads the volumes a ``.list`` file names from
``{root}/data/{id}.h5``, or holds in-memory ones
(:meth:`VolumeTrainDataset.from_samples`); ``RandomCrop3D`` pads where
needed and crops at random; ``RandomRotFlip3D`` rotates by k x 90° in the
last two axes and flips one axis. The transforms are copies of JAX's and
draw the same numpy streams from the same seed, so they give the same
arrays. ``h5py`` is imported where a file is read or written: the machine
with the card has none.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from mamba_unet_torch.data.synthetic import phantom_btcv


class RandomCrop3D:
    def __init__(self, output_size: Sequence[int], seed: int = 0):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        pads = [max(0, o - s) for o, s in zip(self.output_size, image.shape)]
        if any(pads):
            pw = [(p // 2 + 1, p - p // 2 + 1) if p else (0, 0)
                  for p in pads]
            image = np.pad(image, pw, mode="constant")
            label = np.pad(label, pw, mode="constant")
        starts = [int(self.rng.integers(0, s - o + 1))
                  for s, o in zip(image.shape, self.output_size)]
        sl = tuple(np.s_[st:st + o]
                   for st, o in zip(starts, self.output_size))
        return {"image": image[sl], "label": label[sl]}


class RandomRotFlip3D:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        k = int(self.rng.integers(0, 4))
        image = np.rot90(image, k, axes=(1, 2))
        label = np.rot90(label, k, axes=(1, 2))
        axis = int(self.rng.integers(0, 3))
        image = np.flip(image, axis=axis).copy()
        label = np.flip(label, axis=axis).copy()
        return {"image": image, "label": label}


class Compose3D:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class VolumeTrainDataset:
    """3-D volumes: ``{root}/{list_name}`` lines -> ``{root}/data/{id}.h5``
    (``num`` keeps the first). An item is ``image`` (D, H, W, 1) float32,
    ``label`` (D, H, W) int64 and ``idx``, after ``transform``."""

    def __init__(self, base_dir: str, list_name: str = "train.list",
                 transform=None, num: Optional[int] = None):
        self.base_dir = base_dir
        with open(os.path.join(base_dir, list_name)) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        if num is not None:
            self.ids = self.ids[:num]
        self.transform = transform
        self._samples = None

    @classmethod
    def from_samples(cls, samples, transform=None) -> "VolumeTrainDataset":
        """A dataset over in-memory volumes (``image``, ``label``; e.g.
        ``data.synthetic.phantom_btcv``), read as the h5 ones are."""
        ds = cls.__new__(cls)
        ds.base_dir, ds.transform = None, transform
        ds.ids = [s.get("case", str(i)) for i, s in enumerate(samples)]
        ds._samples = [{"image": np.asarray(s["image"], np.float32),
                        "label": np.asarray(s["label"], np.int64)}
                       for s in samples]
        return ds

    def __len__(self) -> int:
        return len(self.ids)

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        if self._samples is not None:
            return dict(self._samples[idx])
        import h5py

        with h5py.File(os.path.join(self.base_dir, "data",
                                    f"{self.ids[idx]}.h5"), "r") as f:
            return {"image": np.asarray(f["image"], np.float32),
                    "label": np.asarray(f["label"], np.int64)}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self._load(idx)
        if self.transform is not None:
            sample = self.transform(sample)
        return {"image": sample["image"].astype(np.float32)[..., None],
                "label": sample["label"].astype(np.int64),
                "idx": idx}


def make_synthetic_btcv(root: str, n_train: int = 4, n_val: int = 1,
                        size: int = 64, num_classes: int = 14,
                        seed: int = 0) -> str:
    """Write :func:`~mamba_unet_torch.data.synthetic.phantom_btcv`'s
    volumes as JAX's ``make_synthetic_btcv`` does: ``{root}/data/*.h5``
    (``image`` float32, ``label`` uint8), ``train.list`` and
    ``val.list``. Needs ``h5py``."""
    import h5py

    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    splits = phantom_btcv(n_train, n_val, size, num_classes, seed)
    for split in ("train", "val"):
        ids = []
        for vol in splits[split]:
            with h5py.File(os.path.join(root, "data", f"{vol['case']}.h5"),
                           "w") as f:
                f.create_dataset("image", data=vol["image"])
                f.create_dataset("label", data=vol["label"].astype(np.uint8))
            ids.append(vol["case"])
        with open(os.path.join(root, f"{split}.list"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root
