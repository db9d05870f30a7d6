"""Synthetic cardiac-like phantom slices and volumes, in memory.

``_phantom`` is the phantom of ``mamba_unet_tpu/data/synthetic.py`` (class 1
RV-like crescent, class 2 myocardium-like ring, class 3 LV-like disk on a
noisy background), copied rather than imported because the JAX package's
``data`` package imports ``jax``. It takes a height and a width, so slices
can have ACDC's non-square native size; for a square slice it draws the
same numbers as the JAX version.

:func:`phantom_acdc` is the in-memory counterpart of that module's
``make_synthetic_acdc`` (default phantom): the same splits, drawn in the
same order from one seed, so for square slices it holds the same arrays
that function writes to h5. Nothing is written: the machine with the card
has no ``h5py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _phantom(rng: np.random.Generator, h: int, w: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    size = min(h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h / 8, h / 8)
    cx = w / 2 + rng.uniform(-w / 8, w / 8)
    r = np.hypot(yy - cy, xx - cx)
    r_lv = size * rng.uniform(0.06, 0.10)
    r_myo = r_lv + size * rng.uniform(0.04, 0.07)
    label = np.zeros((h, w), np.uint8)
    label[r < r_myo] = 2  # myocardium ring
    label[r < r_lv] = 3  # LV blood pool
    # RV: a crescent left of the LV
    rv_cx = cx - r_myo * rng.uniform(1.1, 1.5)
    rv = np.hypot(yy - cy, xx - rv_cx) < r_myo * rng.uniform(0.7, 1.0)
    label[rv & (label == 0)] = 1
    image = 0.2 + 0.15 * rng.standard_normal((h, w)).astype(np.float32)
    image += 0.3 * (label == 1) + 0.5 * (label == 2) + 0.9 * (label == 3)
    image = np.clip(image, 0, 1).astype(np.float32)
    return image, label


def _volumes(rng: np.random.Generator, prefix: str, n_cases: int,
             n_slices: int, h: int, w: int) -> List[Dict[str, np.ndarray]]:
    vols = []
    for c in range(n_cases):
        pairs = [_phantom(rng, h, w) for _ in range(n_slices)]
        vols.append({
            "image": np.stack([p[0] for p in pairs]),
            "label": np.stack([p[1] for p in pairs]).astype(np.int64),
            "case": f"{prefix}{c:03d}",
        })
    return vols


def phantom_volumes(n_cases: int, n_slices: int, h: int, w: int,
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_cases`` volumes as ``VolumeDataset`` items: ``image`` (Z, h, w)
    float32, ``label`` (Z, h, w) int64, ``case``."""
    return _volumes(np.random.default_rng(seed), "phantom", n_cases,
                    n_slices, h, w)


def phantom_acdc(n_train_cases: int = 4, slices_per_case: int = 4,
                 n_val_cases: int = 2, n_test_cases: int = 0, h: int = 64,
                 w: Optional[int] = None, seed: int = 0
                 ) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """In-memory ACDC-format splits: ``train`` is a list of slices
    (``image`` (h, w) float32, ``label`` (h, w) int64), in the order of
    ``train_slices.list``; ``val`` and ``test`` are ``VolumeDataset``
    items of ``slices_per_case`` slices each."""
    w = h if w is None else w
    rng = np.random.default_rng(seed)
    train = []
    for _ in range(n_train_cases * slices_per_case):
        image, label = _phantom(rng, h, w)
        train.append({"image": image, "label": label.astype(np.int64)})
    val = _volumes(rng, "val_patient", n_val_cases, slices_per_case, h, w)
    test = _volumes(rng, "test_patient", n_test_cases, slices_per_case, h, w)
    return {"train": train, "val": val, "test": test}
