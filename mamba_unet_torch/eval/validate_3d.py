"""3-D validation: sliding-window inference and the four-metric table per
case.

Copy of ``mamba_unet_tpu/eval/validate_3d.py`` (the reference's
``test_util.py`` ``validation_all_case``), not imported: the machine that
serves the port has no ``jax``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from mamba_unet_torch.eval.inference import sliding_window_inference_3d
from mamba_unet_torch.eval.metrics import calculate_metric_percase_full


def validation_all_case(
    dataset,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    num_classes: int,
    patch_size: Sequence[int] = (96, 96, 96),
    stride: Sequence[int] = (16, 16, 16),
    gaussian_weighting: bool = False,
) -> np.ndarray:
    """``dataset[i]`` is a dict with a (D, H, W) or (D, H, W, 1) ``image``
    and a (D, H, W) ``label``. Returns (cases, num_classes - 1, 4): per
    foreground class [dice, hd95, nsd, asd]."""
    results = []
    for i in range(len(dataset)):
        case = dataset[i]
        image = np.asarray(case["image"])
        if image.ndim == 4:  # (D, H, W, 1)
            image = image[..., 0]
        label = np.asarray(case["label"])
        pred = sliding_window_inference_3d(
            image, predict_fn, num_classes, patch_size, stride,
            gaussian_weighting)
        results.append([calculate_metric_percase_full(pred == c, label == c)
                        for c in range(1, num_classes)])
    return np.asarray(results, np.float64)
