"""Binary segmentation metrics (Dice, HD95, ASD) in numpy/scipy.

Copied from ``mamba_unet_tpu/eval/metrics.py`` (``dice_binary``, ``hd95``,
``asd``, ``calculate_metric_percase`` and their helpers), not imported: any
import from ``mamba_unet_tpu`` runs its ``data`` package, which imports
``jax``, and the machine that serves the port has no ``jax``. The two copies
are held equal by ``tests/test_torch_modules.py``. ``dice_hd95_asd`` is the
per-class row of ``mamba_unet_tpu/cli/test.py`` (its ``case_metrics``).

Surface = mask minus its erosion with the connectivity-1 structuring
element; distances are the EDT of the complement of the other surface (the
medpy algorithm).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def _as_bool(x) -> np.ndarray:
    return np.asarray(x).astype(bool)


def dice_binary(pred, gt) -> float:
    """Dice coefficient 2|A∩B| / (|A|+|B|) (medpy.metric.binary.dc)."""
    pred, gt = _as_bool(pred), _as_bool(gt)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 0.0
    return float(2.0 * np.logical_and(pred, gt).sum() / denom)


def _surface(mask: np.ndarray) -> np.ndarray:
    """Border voxels: mask minus its erosion (connectivity-1 structure)."""
    struct = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=struct, iterations=1)
    return mask ^ eroded


def surface_distances(
    result, reference, voxelspacing: Optional[Sequence[float]] = None
) -> np.ndarray:
    """Distances from every surface voxel of ``result`` to the surface of
    ``reference`` (one-directional; medpy ``__surface_distances``)."""
    result, reference = _as_bool(result), _as_bool(reference)
    if result.sum() == 0 or reference.sum() == 0:
        raise ValueError("surface distance undefined for empty masks")
    rs = _surface(result)
    ref_s = _surface(reference)
    dt = ndimage.distance_transform_edt(~ref_s, sampling=voxelspacing)
    return dt[rs]


def hd95(result, reference, voxelspacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy hd95)."""
    d1 = surface_distances(result, reference, voxelspacing)
    d2 = surface_distances(reference, result, voxelspacing)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def asd(result, reference, voxelspacing=None) -> float:
    """Average (one-directional) surface distance (medpy asd)."""
    return float(surface_distances(result, reference, voxelspacing).mean())


def calculate_metric_percase(pred, gt) -> Tuple[float, float]:
    """(dice, hd95) with the reference's empty guard: empty prediction OR
    empty ground truth -> (0, 0)."""
    pred, gt = _as_bool(pred), _as_bool(gt)
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_binary(pred, gt), hd95(pred, gt)
    return 0.0, 0.0


def dice_hd95_asd(pred, gt) -> Tuple[float, float, float]:
    """(dice, hd95, asd), the test CLI's per-class row, with the same empty
    guard: empty prediction OR empty ground truth -> (0, 0, 0)."""
    pred, gt = _as_bool(pred), _as_bool(gt)
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_binary(pred, gt), hd95(pred, gt), asd(pred, gt)
    return 0.0, 0.0, 0.0
