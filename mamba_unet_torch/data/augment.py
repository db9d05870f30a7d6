"""Host-side numpy augmentations of the training slices.

Copied from ``random_rot_flip``, ``random_rotate``, ``_resize_pair`` and
``RandomGenerator`` in ``mamba_unet_tpu/data/augment.py`` (scipy + numpy;
the JAX package cannot be imported without ``jax``). For one seed they draw
the same numbers and give the same arrays. Outputs are channels-last: image
(H, W, 1) float32, label (H, W) int64.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage
from scipy.ndimage import zoom as nd_zoom


def random_rot_flip(rng: np.random.Generator, image: np.ndarray,
                    label: Optional[np.ndarray] = None):
    k = int(rng.integers(0, 4))
    axis = int(rng.integers(0, 2))
    image = np.flip(np.rot90(image, k), axis=axis).copy()
    if label is None:
        return image
    label = np.flip(np.rot90(label, k), axis=axis).copy()
    return image, label


def random_rotate(rng: np.random.Generator, image: np.ndarray,
                  label: np.ndarray, label_cval: float = 0.0):
    """Rotate by a whole angle in [-20, 20); ``label_cval`` fills the
    label's rotated-out corners."""
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False,
                           cval=label_cval)
    return image, label


def _resize_pair(image, label, output_size):
    x, y = image.shape
    fx, fy = output_size[0] / x, output_size[1] / y
    if (fx, fy) != (1.0, 1.0):
        image = nd_zoom(image, (fx, fy), order=0)
        label = nd_zoom(label, (fx, fy), order=0)
    return image, label


class RandomGenerator:
    """The standard train transform: coin-flip rot90 + flip, else coin-flip
    rotate by up to 20 degrees, then order-0 zoom to the patch size."""

    def __init__(self, output_size: Sequence[int], seed: int = 0,
                 label_cval: float = 0.0):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)
        self.label_cval = label_cval

    def __call__(self, sample: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
        image, label = sample["image"], sample["label"]
        if self.rng.random() > 0.5:
            image, label = random_rot_flip(self.rng, image, label)
        elif self.rng.random() > 0.5:
            image, label = random_rotate(self.rng, image, label,
                                         label_cval=self.label_cval)
        image, label = _resize_pair(image, label, self.output_size)
        return {
            "image": image.astype(np.float32)[..., None],
            "label": label.astype(np.int64),
        }
