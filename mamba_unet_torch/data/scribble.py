"""Scribble annotations for weakly-supervised training (Weak-Mamba-UNet).

Copied from ``_random_walk`` and ``scribbles_from_mask`` in
``mamba_unet_tpu/data/scribble.py`` (numpy + scipy; the JAX package cannot
be imported without ``jax``). From the same ``np.random.Generator`` it
draws the same numbers and gives the same arrays.

A scribble label is sparse: one momentum random walk per class present in
the slice, inside the class region eroded away from its boundary, and
every other pixel ``ignore_index`` (4 for ACDC's classes 0-3: the
ACDC-scribble convention, where 4 means "unlabeled").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import binary_erosion

# 8-connected step directions for the walk.
_DIRS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
)


def _random_walk(mask: np.ndarray, rng: np.random.Generator,
                 n_steps: int) -> np.ndarray:
    """Boolean trace of a momentum random walk inside ``mask``: the
    direction is kept with p = 0.7 and re-rolled whenever the next pixel
    would leave the mask."""
    trace = np.zeros_like(mask, dtype=bool)
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return trace
    i = int(rng.integers(len(ys)))
    y, x = int(ys[i]), int(xs[i])
    trace[y, x] = True
    d = _DIRS[int(rng.integers(8))]
    h, w = mask.shape
    for _ in range(n_steps):
        if rng.random() > 0.7:
            d = _DIRS[int(rng.integers(8))]
        ny, nx = y + d[0], x + d[1]
        if 0 <= ny < h and 0 <= nx < w and mask[ny, nx]:
            y, x = ny, nx
            trace[y, x] = True
        else:
            d = _DIRS[int(rng.integers(8))]
    return trace


def scribbles_from_mask(label: np.ndarray, rng: np.random.Generator,
                        ignore_index: int = 4, erosion_iters: int = 2
                        ) -> np.ndarray:
    """Sparse scribble annotation (uint8) of a dense (H, W) int mask: one
    walk per class present (background included), inside the class region
    eroded by ``erosion_iters`` (the whole region when erosion empties it),
    of ``clip(pixels // 8, 15, 300)`` steps; ``ignore_index`` elsewhere."""
    label = np.asarray(label)
    out = np.full(label.shape, ignore_index, dtype=np.uint8)
    for k in np.unique(label):
        mask = label == k
        core = binary_erosion(mask, iterations=erosion_iters)
        if not core.any():
            core = mask
        npix = int(core.sum())
        n_steps = int(np.clip(npix // 8, 15, 300))
        out[_random_walk(core, rng, n_steps)] = k
    return out
