"""Volume inference: per-slice order-0 resize, batched forward, argmax.

Copied from ``mamba_unet_tpu/eval/inference.py`` (``_zoom0``,
``_predict_batched``, ``test_single_volume``), not imported: any import from
``mamba_unet_tpu`` runs its ``data`` package, which imports ``jax``, and the
machine that serves the port has no ``jax``. ``_zoom0`` here is scipy only
(the JAX package may use its native resize, which matches scipy exactly).
The copies are held equal by ``tests/test_torch_modules.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
from scipy.ndimage import zoom as nd_zoom

from mamba_unet_torch.eval.metrics import calculate_metric_percase


def _zoom0(arr: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """Order-0 (nearest) 2-D resize to ``out_shape`` with scipy."""
    h, w = arr.shape
    return nd_zoom(arr, (out_shape[0] / h, out_shape[1] / w), order=0)


def _predict_batched(
    inp: np.ndarray, predict_fn: Callable, batch_size: Optional[int]
) -> np.ndarray:
    """(Z, ps, ps, C_in) -> argmax'd (Z, ps, ps). Tail batches are padded
    with zeros, so ``predict_fn`` always sees ``batch_size`` slices."""
    z = inp.shape[0]
    bs = batch_size or z
    preds = []
    for s in range(0, z, bs):
        chunk = inp[s : s + bs]
        pad = bs - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad, *chunk.shape[1:]), np.float32)]
            )
        logits = np.asarray(predict_fn(chunk))
        if pad:
            logits = logits[: bs - pad]
        preds.append(np.argmax(logits, axis=-1))
    return np.concatenate(preds, axis=0)


def test_single_volume(
    image: np.ndarray,
    label: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    classes: int,
    patch_size: Sequence[int] = (256, 256),
    batch_size: Optional[int] = None,
    metric_fn: Callable = calculate_metric_percase,
    return_pred: bool = False,
):
    """Evaluate one volume.

    image, label: (Z, H, W) numpy. predict_fn: (B, ps, ps, 1) float32 ->
    (B, ps, ps, C) logits. Returns ``[metric_fn(pred == i, label == i)]``
    for classes 1..classes-1, by default (dice, hd95) each; with
    ``return_pred`` also the (Z, ps, ps) prediction at the patch size, as
    ``(metrics, pred_small)``.
    """
    image = np.asarray(image)
    label = np.asarray(label)
    z, x, y = image.shape
    ps = tuple(patch_size)

    if (x, y) != ps:
        slices = np.stack([_zoom0(image[i], ps) for i in range(z)])
    else:
        slices = image
    inp = slices.astype(np.float32)[..., None]  # (Z, ps, ps, 1)

    out = _predict_batched(inp, predict_fn, batch_size)

    if (x, y) != ps:
        prediction = np.stack([_zoom0(out[i], (x, y)) for i in range(z)])
    else:
        prediction = out

    metrics = [metric_fn(prediction == i, label == i)
               for i in range(1, classes)]
    return (metrics, out) if return_pred else metrics

