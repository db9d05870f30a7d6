"""CTATransform: a CTAugment weak/strong pair and the jigsaw views.

Copied from ``mamba_unet_tpu/data/cta_transform.py`` (host-side numpy and
PIL) and held bitwise equal to it for the same seed by the CPU tests:
resize (order-0 zoom) -> weak = cta_apply(image, ops_weak); strong =
cta_apply(weak, ops_strong); label_aug = cta_apply(label, ops_weak),
rounded back to int; plus the grid-shuffled jigsaw view and its block
permutation. The op policies are mutable attributes, so the trainer
refreshes them per epoch (:meth:`CTATransform.refresh_policies`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image
from scipy.ndimage import zoom as nd_zoom

from mamba_unet_torch.data.ctaugment import (
    CTAugment,
    cta_apply,
    get_grid_shuffle_index,
    grid_shuffle_image,
    np_to_pil,
    pil_to_np,
)


class CTATransform:
    def __init__(self, output_size: Sequence[int], cta: CTAugment,
                 grid_shape: Tuple[int, int] = (4, 4), seed: int = 0):
        self.output_size = tuple(output_size)
        self.cta = cta
        self.grid_shape = grid_shape
        self.rng = np.random.default_rng(seed)
        self.ops_weak = cta.policy(probe=False, weak=True)
        self.ops_strong = cta.policy(probe=False, weak=False)

    def refresh_policies(self) -> None:
        self.ops_weak = self.cta.policy(probe=False, weak=True)
        self.ops_strong = self.cta.policy(probe=False, weak=False)

    def _resize(self, arr, order=0):
        x, y = arr.shape
        return nd_zoom(arr, (self.output_size[0] / x, self.output_size[1] / y),
                       order=order)

    def __call__(self, sample):
        image = self._resize(sample["image"].astype(np.float32))
        label = self._resize(sample["label"].astype(np.uint8))

        pil_img = np_to_pil(image)
        weak = cta_apply(pil_img, self.ops_weak, rng=self.rng)
        strong = cta_apply(weak, self.ops_strong, rng=self.rng)
        label_pil = Image.fromarray(label.astype(np.uint8))
        label_aug = np.asarray(cta_apply(label_pil, self.ops_weak,
                                         rng=self.rng))
        label_aug = np.rint(label_aug).astype(np.int64)

        shuffle_idx, grid_perm = get_grid_shuffle_index(
            self.rng, image.shape, self.grid_shape)
        jigsaw = grid_shuffle_image(image, shuffle_idx)

        return {
            "image": image.astype(np.float32)[..., None],
            "label": label.astype(np.int64),
            "image_weak": pil_to_np(weak).astype(np.float32)[..., None],
            "image_strong": pil_to_np(strong).astype(np.float32)[..., None],
            "label_aug": label_aug,
            "jigsaw_image": jigsaw.astype(np.float32)[..., None],
            "jigsaw_index": grid_perm.astype(np.int64),
        }
