"""Volume inference: per-slice order-0 resize, batched forward, argmax;
and tiled 3-D inference.

Copied from ``mamba_unet_tpu/eval/inference.py`` (``_zoom0``,
``_predict_batched``, ``test_single_volume``, ``evaluate_slice_volumes``,
``test_single_volume_mad``, ``test_single_volume_stacked`` (MAD's
validations), ``gaussian_importance_map``, ``sliding_window_inference_3d``),
not imported: any import from
``mamba_unet_tpu`` runs its ``data`` package, which imports ``jax``, and the
machine that serves the port has no ``jax``. ``_zoom0`` here is scipy only
(the JAX package may use its native resize, which matches scipy exactly).
The copies are held equal by ``tests/test_torch_modules.py``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

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


def evaluate_slice_volumes(
    volumes,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    classes: int,
    patch_size: Sequence[int] = (256, 256),
    batch_size: int = 16,
) -> np.ndarray:
    """Batched whole-val-set slice inference (the trainer's eval).

    All volumes' slices are resized on the host, concatenated and streamed
    through ``predict_fn`` in ``batch_size`` chunks, so only the one global
    tail is padded. Per slice: order-0 zoom to the patch size, argmax, zoom
    back, metrics at native resolution. ``volumes`` is an iterable of dicts
    with (Z, H, W) ``image``/``label``. Returns (cases, classes-1, 2)
    [dice, hd95].
    """
    vols = [(np.asarray(v["image"]), np.asarray(v["label"])) for v in volumes]
    ps = tuple(patch_size)

    all_slices, spans = [], []
    for image, _ in vols:
        z, x, y = image.shape
        start = len(all_slices)
        if (x, y) != ps:
            all_slices.extend(_zoom0(image[i], ps) for i in range(z))
        else:
            all_slices.extend(image)
        spans.append((start, len(all_slices), (x, y)))

    inp = np.asarray(all_slices, np.float32)[..., None]  # (N, ps, ps, 1)
    out = _predict_batched(inp, predict_fn, batch_size)

    metrics = []
    for (start, stop, (x, y)), (_, label) in zip(spans, vols):
        pred = out[start:stop]
        if (x, y) != ps:
            pred = np.stack([_zoom0(p, (x, y)) for p in pred])
        metrics.append([
            calculate_metric_percase(pred == i, label == i)
            for i in range(1, classes)
        ])
    return np.asarray(metrics)


def test_single_volume_mad(
    label: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    classes: int,
    corrupt_fn: Callable[[np.ndarray], np.ndarray],
    patch_size: Sequence[int] = (256, 256),
    batch_size: Optional[int] = None,
) -> List[Tuple[float, float]]:
    """The MAD denoiser's validation (the reference's ``val_2D.py:54-78``):
    the network's input is a corrupted near-one-hot of each label slice
    (``corrupt_fn``: (ps, ps) label -> (ps, ps, C)), and the metrics compare
    the denoised argmax with the clean label. The image is not used (the
    reference's ``image = label.copy()``)."""
    label = np.asarray(label)
    z, x, y = label.shape
    ps = tuple(patch_size)
    slices = [
        corrupt_fn(_zoom0(label[i].astype(np.float32), ps)) for i in range(z)
    ]
    inp = np.stack(slices).astype(np.float32)  # (Z, ps, ps, C)
    out = _predict_batched(inp, predict_fn, batch_size)
    if (x, y) != ps:
        prediction = np.stack([_zoom0(out[i], (x, y)) for i in range(z)])
    else:
        prediction = out
    return [
        calculate_metric_percase(prediction == i, label == i)
        for i in range(1, classes)
    ]


def test_single_volume_stacked(
    image: np.ndarray,
    label: np.ndarray,
    seg_fn: Callable[[np.ndarray], np.ndarray],
    den_fn: Callable[[np.ndarray], np.ndarray],
    classes: int,
    patch_size: Sequence[int] = (256, 256),
    batch_size: Optional[int] = None,
) -> List[Tuple[float, float]]:
    """The stacked seg -> denoiser validation (the reference's
    ``val_2D.py:80-103``): prediction = argmax(den(softmax(seg(x)))), the
    softmax in numpy on the host."""

    def composed(x):
        logits = np.asarray(seg_fn(x))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return den_fn((e / e.sum(axis=-1, keepdims=True)).astype(np.float32))

    return test_single_volume(
        image, label, composed, classes, patch_size, batch_size
    )


def gaussian_importance_map(patch_size: Sequence[int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """nnU-Net's Gaussian tile weighting: a centered Gaussian, normalized
    to max 1, its zeros raised to the least positive value so every voxel
    keeps a weight."""
    from scipy.ndimage import gaussian_filter

    tmp = np.zeros(patch_size, np.float32)
    tmp[tuple(s // 2 for s in patch_size)] = 1.0
    g = gaussian_filter(tmp, [s * sigma_scale for s in patch_size],
                        mode="constant")
    g = g / g.max()
    g[g == 0] = g[g > 0].min()
    return g.astype(np.float32)


def sliding_window_inference_3d(
    image: np.ndarray,
    predict_fn: Callable[[np.ndarray], np.ndarray],
    num_classes: int,
    patch_size: Sequence[int] = (96, 96, 96),
    stride: Sequence[int] = (16, 16, 16),
    gaussian_weighting: bool = False,
) -> np.ndarray:
    """Tiled 3-D inference with score accumulation on the host.

    ``image`` (D, H, W), zero-padded (centered) up to ``patch_size`` where
    smaller; ``predict_fn`` (1, pd, ph, pw, 1) -> (1, pd, ph, pw, C)
    logits, one call per window, the last window of each axis flush with
    the end. The softmax of each window, weighted (uniformly, or by
    :func:`gaussian_importance_map`), is summed and divided by the summed
    weights. Returns the argmax label volume (D, H, W)."""
    image = np.asarray(image, np.float32)
    pd, ph, pw = patch_size
    d, h, w = image.shape
    pads = [max(0, p - s) for p, s in zip(patch_size, image.shape)]
    pad_width = [(pz // 2, pz - pz // 2) for pz in pads]
    padded = np.pad(image, pad_width, mode="constant") if any(pads) else image
    dd, hh, ww = padded.shape

    sx = math.ceil((dd - pd) / stride[0]) + 1 if dd > pd else 1
    sy = math.ceil((hh - ph) / stride[1]) + 1 if hh > ph else 1
    sz = math.ceil((ww - pw) / stride[2]) + 1 if ww > pw else 1

    weight = (gaussian_importance_map(patch_size) if gaussian_weighting
              else np.ones(patch_size, np.float32))
    score = np.zeros((num_classes, dd, hh, ww), np.float32)
    cnt = np.zeros((dd, hh, ww), np.float32)
    for ix in range(sx):
        xs = min(ix * stride[0], dd - pd)
        for iy in range(sy):
            ys = min(iy * stride[1], hh - ph)
            for iz in range(sz):
                zs = min(iz * stride[2], ww - pw)
                patch = padded[xs:xs + pd, ys:ys + ph, zs:zs + pw]
                logits = np.asarray(predict_fn(patch[None, ..., None]))[0]
                e = np.exp(logits - logits.max(axis=-1, keepdims=True))
                prob = e / e.sum(axis=-1, keepdims=True)  # (pd, ph, pw, C)
                score[:, xs:xs + pd, ys:ys + ph, zs:zs + pw] += (
                    prob.transpose(3, 0, 1, 2) * weight[None])
                cnt[xs:xs + pd, ys:ys + ph, zs:zs + pw] += weight
    score /= np.maximum(cnt, 1e-8)[None]
    pred = np.argmax(score, axis=0)
    if any(pads):
        (d0, _), (h0, _), (w0, _) = pad_width
        pred = pred[d0:d0 + d, h0:h0 + h, w0:w0 + w]
    return pred
