"""MAD (mask-autoencoder-denoiser) label-corruption transforms.

Copied from ``mamba_unet_tpu/data/mad_augment.py`` (host numpy and scipy,
not imported: the JAX package's ``data`` imports ``jax``): the puzzle and
Canny-edge masks, the near-one-hot softmax of a label map, and the
pretraining, fine-tuning and fusion transforms. For one
``np.random.default_rng`` seed they draw the same numbers and give the same
arrays (``tests/test_torch_mad.py``). The JAX copy calls OpenCV's
``cv2.Canny``, which the machine that trains the port lacks; :func:`canny`
is that function's arithmetic in numpy (L1 gradient magnitude of 3x3 Sobel
derivatives with replicated borders, non-maximum suppression along the
gradient quantized at 22.5 and 67.5 degrees in OpenCV's fixed point, and
hysteresis over 8-connected neighbours), equal to it pixel for pixel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage
from scipy.ndimage import zoom as nd_zoom

from mamba_unet_torch.data.augment import random_rot_flip, random_rotate

# OpenCV's Canny fixed point: tan(22.5 deg) in Q15
_CANNY_SHIFT = 15
_TG22 = 13573


def canny(image: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(image, low, high)`` (aperture 3, L1 gradient) of a
    uint8 (H, W) image: 255 on the edges, else 0."""
    src = np.asarray(image, np.uint8).astype(np.int64)
    p = np.pad(src, 1, mode="edge")
    dx = ((p[:-2, 2:] - p[:-2, :-2]) + 2 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[2:, 2:] - p[2:, :-2]))
    dy = ((p[2:, :-2] - p[:-2, :-2]) + 2 * (p[2:, 1:-1] - p[:-2, 1:-1])
          + (p[2:, 2:] - p[:-2, 2:]))
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)  # 0 outside the image
    c = m[1:-1, 1:-1]
    ax, ay = np.abs(dx), np.abs(dy) << _CANNY_SHIFT
    tg22x = ax * _TG22
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg22x + (ax << (_CANNY_SHIFT + 1)))
    same_sign = (dx ^ dy) >= 0
    peak = np.where(
        horiz, (c > m[1:-1, :-2]) & (c >= m[1:-1, 2:]),
        np.where(vert, (c > m[:-2, 1:-1]) & (c >= m[2:, 1:-1]),
                 np.where(same_sign,
                          (c > m[:-2, :-2]) & (c > m[2:, 2:]),
                          (c > m[:-2, 2:]) & (c > m[2:, :-2]))))
    cand = (c > int(np.floor(low))) & peak
    strong = cand & (c > int(np.floor(high)))
    labels, n = ndimage.label(cand, structure=np.ones((3, 3), int))
    keep = np.zeros(n + 1, bool)
    keep[labels[strong]] = True
    keep[0] = False
    return np.where(keep[labels], 255, 0).astype(np.uint8)


def random_mask_puzzle(rng, image, mask_rate=0.25, mask_size=(8, 8)):
    """Zero ``mask_rate`` of the (H/ms, W/ms) grid cells."""
    x, y = image.shape
    ms = mask_size[0]
    gx, gy = x // ms, y // ms
    img = image.copy().reshape(gx, ms, gy, ms).transpose(0, 2, 1, 3)
    flat = img.reshape(-1, ms, ms)
    n_zero = int(flat.shape[0] * mask_rate)
    idx = rng.choice(flat.shape[0], n_zero, replace=False)
    flat[idx] = 0
    img = flat.reshape(gx, gy, ms, ms).transpose(0, 2, 1, 3).reshape(x, y)
    return img


def random_mask_edge(rng, image, mask_rate=0.03, mask_size=(4, 4), mask_val=-1):
    """Overwrite neighborhoods of random Canny edge pixels with a constant or
    a randomly drawn neighborhood value."""
    img = image.copy()
    edges = canny(img.astype(np.uint8), 1, 2)
    rows, cols = np.where(edges == 255)
    if len(rows) == 0:
        return img
    n = int(len(rows) * mask_rate)
    sel = rng.choice(len(rows), min(n, len(rows)), replace=False)
    for i in sel:
        r, c = rows[i], cols[i]
        top = max(0, r - mask_size[1])
        bottom = min(img.shape[0], r + mask_size[1])
        left = max(0, c - mask_size[0])
        right = min(img.shape[1], c + mask_size[0])
        if mask_val < 0:
            val = rng.choice(img[top:bottom, left:right].reshape(-1))
        else:
            val = mask_val
        img[top:bottom, left:right] = val
    return img


def image2binary(img, error_val=1e-3, num_classes=4):
    """Label map -> near-one-hot channel stack (CHW in ref; HWC here)."""
    out = np.full((*img.shape, num_classes), error_val, np.float32)
    for i in range(num_classes):
        out[..., i][img == i] = 1 - error_val
    return out


def np_softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def random_scale_2d(rng, image, label, scale_range=(0.8, 1.2)):
    s = rng.uniform(*scale_range)
    image = nd_zoom(image, s, order=0)
    label = nd_zoom(label, s, order=0)
    return image, label


def random_crop_2d(rng, image, label, output_size):
    """Pad (+3 margin) then random-crop (dataset.py:190-207)."""
    if label.shape[0] <= output_size[0] or label.shape[1] <= output_size[1]:
        pw = max((output_size[0] - label.shape[0]) // 2 + 3, 0)
        ph = max((output_size[1] - label.shape[1]) // 2 + 3, 0)
        image = np.pad(image, [(pw, pw), (ph, ph)], constant_values=0)
        label = np.pad(label, [(pw, pw), (ph, ph)], constant_values=0)
    w, h = image.shape
    w1 = rng.integers(0, w - output_size[0])
    h1 = rng.integers(0, h - output_size[1])
    sl = np.s_[w1 : w1 + output_size[0], h1 : h1 + output_size[1]]
    return image[sl], label[sl]


def resize_pair(image, label, output_size):
    x, y = image.shape
    f = (output_size[0] / x, output_size[1] / y)
    if f != (1.0, 1.0):
        image = nd_zoom(image, f, order=0)
        label = nd_zoom(label, f, order=0)
    return image, label


class RandomGeneratorV2:
    """rot/flip | rotate, then scale(0.8-1.2) + pad/crop + resize
    (dataset.py:525-543)."""

    def __init__(self, output_size: Sequence[int], seed: int = 0):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        if self.rng.random() > 0.5:
            image, label = random_rot_flip(self.rng, image, label)
        elif self.rng.random() > 0.5:
            image, label = random_rotate(self.rng, image, label)
        image, label = random_scale_2d(self.rng, image, label)
        image, label = random_crop_2d(self.rng, image, label, self.output_size)
        image, label = resize_pair(image, label, self.output_size)
        return {
            "image": image.astype(np.float32)[..., None],
            "label": label.astype(np.int64),
        }


_PUZZLE_SIZES = [1, 1, 1, 1, 2, 2, 2, 4, 4, 8]
_PUZZLE_RATES = [0.15, 0.17, 0.19, 0.21, 0.23, 0.25, 0.27, 0.30, 0.35,
                 0.40, 0.45, 0.55, 0.65]
_EDGE_SIZES = [1, 2, 3, 4]


def random_mask_corrupt(rng: np.random.Generator, arr: np.ndarray) -> np.ndarray:
    """One draw of the MAD masking pipeline with randomized parameters
    (gen_mask_param + the 0.20/0.85 branch, dataset.py:705-747): 20% puzzle
    mask, 65% edge mask, 15% both."""
    ms = int(rng.choice(_PUZZLE_SIZES))
    puzzle_rate = float(rng.choice(_PUZZLE_RATES))
    es = int(rng.choice(_EDGE_SIZES))
    total = rng.uniform(1, 4)
    edge_rate = total / 4 / es / es
    val = int(rng.choice([-1, 0]))
    r = rng.random()
    if r < 0.20:
        arr = random_mask_puzzle(rng, arr, puzzle_rate, (ms, ms))
    elif r < 0.85:
        arr = random_mask_edge(rng, arr, edge_rate, (es, es), val)
    else:
        arr = random_mask_edge(rng, arr, edge_rate, (es, es), val)
        arr = random_mask_puzzle(rng, arr, puzzle_rate, (ms, ms))
    return arr


class MADPretrainTransform:
    """RandomGeneratorv3 mode 0 with label corruption: the network INPUT is a
    softmaxed near-one-hot of the (masked) label; target is the clean label.
    (dataset.py:545-673 / MAD_Pretrain.py)."""

    def __init__(self, output_size: Sequence[int], num_classes: int = 4,
                 error_val: float = 1e-3, geometric: bool = True,
                 seed: int = 0):
        self.output_size = tuple(output_size)
        self.num_classes = num_classes
        self.error_val = error_val
        self.geometric = geometric
        self.rng = np.random.default_rng(seed)

    def _corrupt(self, corrupted):
        return random_mask_corrupt(self.rng, corrupted)

    def mask_label_only(self, label2d: np.ndarray) -> np.ndarray:
        """Corrupt + one-hot + softmax a single label slice — the eval-side
        input builder (reference mask_label_onle, dataset.py:792-806)."""
        corrupted = random_mask_corrupt(self.rng, label2d.astype(np.float32))
        return np_softmax(
            image2binary(corrupted, self.error_val, self.num_classes)
        ).astype(np.float32)

    def __call__(self, sample):
        _, label = sample["image"], sample["label"]
        label = label.astype(np.float32)
        if self.geometric:
            if self.rng.random() > 0.5:
                label, _ = random_rot_flip(self.rng, label, label)
            if self.rng.random() > 0.5:
                label, _ = random_rotate(self.rng, label, label)
            label, _ = random_scale_2d(self.rng, label, label)
            label, _ = random_crop_2d(self.rng, label, label, self.output_size)
        label, _ = resize_pair(label, label, self.output_size)
        corrupted = label.copy()
        if self.rng.random() > 0.3:
            corrupted = self._corrupt(corrupted)
        onehot = image2binary(corrupted, self.error_val, self.num_classes)
        return {
            "image": np_softmax(onehot).astype(np.float32),
            "label": label.astype(np.int64),
        }


class MADFineTuneTransform:
    """RandomGeneratorv_4_finetune train mode (dataset.py:680-758): rot/flip
    p.5, rotate p.5, resize; mask_label = ALWAYS-corrupted copy of the label
    (20% puzzle / 65% edge / 15% both, randomized params); joint scale + crop
    of (image, label, mask_label); mask_label -> near-one-hot -> softmax.

    Yields {image (H,W,1), label (H,W), mask_label (H,W,C)} — the batch the
    MADFineTuneTrainer consumes (MAD_FineTuning.py:109-115).
    """

    def __init__(self, output_size: Sequence[int], num_classes: int = 4,
                 error_val: float = 1e-3, seed: int = 0):
        self.output_size = tuple(output_size)
        self.num_classes = num_classes
        self.error_val = error_val
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        rng = self.rng
        image = sample["image"].astype(np.float32)
        label = sample["label"].astype(np.float32)
        if rng.random() > 0.5:
            image, label = random_rot_flip(rng, image, label)
        if rng.random() > 0.5:
            image, label = random_rotate(rng, image, label)
        image, label = resize_pair(image, label, self.output_size)

        mask_label = random_mask_corrupt(rng, label.copy())

        # joint scale + crop on the triple (random_scale_2D_mask /
        # random_crop_2D_mask in the reference)
        s = rng.uniform(0.8, 1.2)
        image, label, mask_label = (
            nd_zoom(a, s, order=0) for a in (image, label, mask_label)
        )
        out = self.output_size
        if label.shape[0] <= out[0] or label.shape[1] <= out[1]:
            pw = max((out[0] - label.shape[0]) // 2 + 3, 0)
            ph = max((out[1] - label.shape[1]) // 2 + 3, 0)
            image, label, mask_label = (
                np.pad(a, [(pw, pw), (ph, ph)], constant_values=0)
                for a in (image, label, mask_label)
            )
        w, h = label.shape
        w1 = int(rng.integers(0, w - out[0]))
        h1 = int(rng.integers(0, h - out[1]))
        sl = np.s_[w1 : w1 + out[0], h1 : h1 + out[1]]
        image, label, mask_label = image[sl], label[sl], mask_label[sl]
        # crops can land off-size when scale shrank exactly to the bound
        image, label = resize_pair(image, label, self.output_size)
        mask_label, _ = resize_pair(mask_label, mask_label, self.output_size)

        onehot = np_softmax(image2binary(mask_label, self.error_val,
                                         self.num_classes))
        return {
            "image": image.astype(np.float32)[..., None],
            "label": label.astype(np.int64),
            "mask_label": onehot.astype(np.float32),
        }


class FusionTransform:
    """RandomGeneratorv3/v4 image-fusion modes 1-7 (dataset.py:636-675,
    catalogued in utils/utils.py:94-104). Sample keys: ``image`` (a cached
    prediction map for the pred-based modes), ``label``, optional
    ``origin_img`` (defaults to ``image``).

      1: [origin, pred] channel stack            (2 ch)
      2: [origin, label]                         (2 ch)
      3: [origin] + binarized label              (1+C ch)
      4: [origin] + masked binarized label       (1+C ch)  (+ mask_label out)
      5: [origin] + binarized pred               (1+C ch)
      6: [origin] + softmax((masked b_label + b_pred)/2)   (1+C ch)
      7: masked binarized label alone            (C ch)
    """

    def __init__(self, output_size, num_classes=4, fusion_mode=1,
                 error_val=1e-4, geometric=True, seed=0):
        assert fusion_mode in range(1, 8)
        self.output_size = tuple(output_size)
        self.num_classes = num_classes
        self.fusion_mode = fusion_mode
        self.error_val = error_val
        self.geometric = geometric
        self.rng = np.random.default_rng(seed)

    def _joint_geometric(self, arrays):
        rng = self.rng
        if rng.random() > 0.5:
            k = int(rng.integers(0, 4))
            axis = int(rng.integers(0, 2))
            arrays = [np.flip(np.rot90(a, k), axis=axis).copy() for a in arrays]
        if rng.random() > 0.5:
            angle = int(rng.integers(-20, 20))
            arrays = [ndimage.rotate(a, angle, order=0, reshape=False)
                      for a in arrays]
        s = rng.uniform(0.8, 1.2)
        arrays = [nd_zoom(a, s, order=0) for a in arrays]
        # shared pad+crop
        out = self.output_size
        a0 = arrays[0]
        if a0.shape[0] <= out[0] or a0.shape[1] <= out[1]:
            pw = max((out[0] - a0.shape[0]) // 2 + 3, 0)
            ph = max((out[1] - a0.shape[1]) // 2 + 3, 0)
            arrays = [np.pad(a, [(pw, pw), (ph, ph)], constant_values=0)
                      for a in arrays]
        w, h = arrays[0].shape
        w1 = int(rng.integers(0, w - out[0]))
        h1 = int(rng.integers(0, h - out[1]))
        sl = np.s_[w1 : w1 + out[0], h1 : h1 + out[1]]
        return [a[sl] for a in arrays]

    def _mask_corrupt(self, label):
        rng = self.rng
        out = label.copy().astype(np.float32)
        if rng.random() > 0.3:
            ms = int(rng.choice(_PUZZLE_SIZES))
            pr = float(rng.choice(_PUZZLE_RATES))
            es = int(rng.choice(_EDGE_SIZES))
            er = rng.uniform(1, 4) / 4 / es / es
            val = int(rng.choice([-1, 0]))
            r = rng.random()
            if r < 0.20:
                out = random_mask_puzzle(rng, out, pr, (ms, ms))
            elif r < 0.85:
                out = random_mask_edge(rng, out, er, (es, es), val)
            else:
                out = random_mask_edge(rng, out, er, (es, es), val)
                out = random_mask_puzzle(rng, out, pr, (ms, ms))
        return out

    def _soft_binary(self, arr):
        return np_softmax(image2binary(arr, self.error_val, self.num_classes))

    def __call__(self, sample):
        pred = sample["image"].astype(np.float32)
        label = sample["label"].astype(np.float32)
        origin = sample.get("origin_img", sample["image"]).astype(np.float32)
        arrays = [pred, label, origin]
        if self.geometric:
            arrays = self._joint_geometric(arrays)
        pred, label, origin = [
            nd_zoom(a, (self.output_size[0] / a.shape[0],
                        self.output_size[1] / a.shape[1]), order=0)
            if a.shape != self.output_size else a
            for a in arrays
        ]
        mode = self.fusion_mode
        out = {"label": label.astype(np.int64)}
        o = origin[..., None]
        if mode == 1:
            image = np.concatenate([o, pred[..., None]], axis=-1)
        elif mode == 2:
            image = np.concatenate([o, label[..., None]], axis=-1)
        elif mode == 3:
            image = np.concatenate([o, self._soft_binary(label)], axis=-1)
        elif mode == 5:
            image = np.concatenate([o, self._soft_binary(pred)], axis=-1)
        else:  # 4, 6, 7: masked binarized label (+ optional pred blend)
            mask_label = self._soft_binary(self._mask_corrupt(label))
            if mode == 6:
                mask_label = np_softmax(
                    (mask_label + self._soft_binary(pred)) / 2.0
                )
            out["mask_label"] = mask_label.astype(np.float32)
            if mode == 7:
                image = mask_label
            else:
                image = np.concatenate([o, mask_label], axis=-1)
        out["image"] = image.astype(np.float32)
        return out
