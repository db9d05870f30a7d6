"""Signed distance field of binary masks (host-side numpy/scipy).

Copied from ``compute_sdf`` in ``mamba_unet_tpu/utils/sdf.py`` (the JAX
package cannot be imported without ``jax``). Per sample, normalised:

    sdf = 0        on the mask's inner boundary
    sdf in [-1, 0) inside the mask   (min-max normalised -EDT)
    sdf in (0, 1]  outside the mask  (min-max normalised +EDT)

The inner boundary is the mask minus its erosion (connectivity 1; the
image border counts as background). An empty mask gives zeros. No trainer
calls it.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_erosion, distance_transform_edt


def compute_sdf(img_gt: np.ndarray, out_shape=None) -> np.ndarray:
    """(B, *spatial) binary masks -> (B, *spatial) float64 signed
    distance maps."""
    img_gt = np.asarray(img_gt).astype(np.uint8)
    if out_shape is None:
        out_shape = img_gt.shape
    normalized_sdf = np.zeros(out_shape)
    for b in range(out_shape[0]):
        posmask = img_gt[b].astype(bool)
        if not posmask.any():
            continue
        negmask = ~posmask
        posdis = distance_transform_edt(posmask)
        negdis = distance_transform_edt(negmask)
        boundary = posmask & ~binary_erosion(posmask, border_value=0)
        pos_rng = np.max(posdis) - np.min(posdis)
        neg_rng = np.max(negdis) - np.min(negdis)
        sdf = (negdis - np.min(negdis)) / max(neg_rng, 1e-12) - (
            posdis - np.min(posdis)) / max(pos_rng, 1e-12)
        sdf[boundary] = 0
        normalized_sdf[b] = sdf
    return normalized_sdf
