"""The training batches worked out again from the raw slices.

The transform of the Mamba-UNet and SSL4MIS training scripts
(``RandomGenerator``): with probability one half a random rot90 and flip,
else with probability one half a rotation by a whole angle in [-20, 20)
degrees (nearest neighbour, corners 0), then an order-0 zoom to the patch
size; the image gains a channel axis. One numpy generator seeded with the
run's seed draws for every slice in the order the slices are served.
The sampler: epoch-shuffled batches of supervised training, from a
numpy generator seeded with the run's seed.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Sequence

import numpy as np
from scipy import ndimage


class Transform:
    def __init__(self, output_size: Sequence[int], seed: int):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)

    def __call__(self, image: np.ndarray, label: np.ndarray):
        rng = self.rng
        if rng.random() > 0.5:
            k, axis = int(rng.integers(0, 4)), int(rng.integers(0, 2))
            image = np.flip(np.rot90(image, k), axis=axis).copy()
            label = np.flip(np.rot90(label, k), axis=axis).copy()
        elif rng.random() > 0.5:
            angle = int(rng.integers(-20, 20))
            image = ndimage.rotate(image, angle, order=0, reshape=False)
            label = ndimage.rotate(label, angle, order=0, reshape=False)
        fx = self.output_size[0] / image.shape[0]
        fy = self.output_size[1] / image.shape[1]
        if (fx, fy) != (1.0, 1.0):
            image = ndimage.zoom(image, (fx, fy), order=0)
            label = ndimage.zoom(label, (fx, fy), order=0)
        return image.astype(np.float32)[..., None], label.astype(np.int64)


def epoch_batches(n: int, batch_size: int, seed: int) -> Iterator[List[int]]:
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(n // batch_size):
            yield perm[i * batch_size:(i + 1) * batch_size].tolist()


def batches(slices: Dict[str, np.ndarray], sampler: Iterator[List[int]],
            transform: Transform, count: int) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` batches: ``image`` (B, H, W, 1) float32,
    ``label`` (B, H, W) int64."""
    out = []
    for idxs in itertools.islice(sampler, count):
        pairs = [transform(slices["image"][i], slices["label"][i])
                 for i in idxs]
        out.append({"image": np.stack([p[0] for p in pairs]),
                    "label": np.stack([p[1] for p in pairs])})
    return out
