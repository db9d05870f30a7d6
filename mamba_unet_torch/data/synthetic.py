"""Synthetic cardiac-like phantom volumes, in memory.

``_phantom`` is the phantom of ``mamba_unet_tpu/data/synthetic.py`` (class 1
RV-like crescent, class 2 myocardium-like ring, class 3 LV-like disk on a
noisy background), copied rather than imported because the JAX package's
``data`` package imports ``jax``. It takes a height and a width, so volumes
can have ACDC's non-square native slices; for a square slice it draws the
same numbers as the JAX version.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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


def phantom_volumes(n_cases: int, n_slices: int, h: int, w: int,
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_cases`` volumes as ``VolumeDataset`` items: ``image`` (Z, h, w)
    float32, ``label`` (Z, h, w) int64, ``case``."""
    rng = np.random.default_rng(seed)
    vols = []
    for c in range(n_cases):
        pairs = [_phantom(rng, h, w) for _ in range(n_slices)]
        vols.append({
            "image": np.stack([p[0] for p in pairs]),
            "label": np.stack([p[1] for p in pairs]).astype(np.int64),
            "case": f"phantom{c:03d}",
        })
    return vols
