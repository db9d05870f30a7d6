"""Batch index sampler.

Copied from ``EpochShuffleSampler`` in ``mamba_unet_tpu/data/sampler.py``.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class EpochShuffleSampler:
    """Plain shuffled batch sampler, drops the last partial batch."""

    def __init__(self, n: int, batch_size: int, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        perm = self.rng.permutation(self.n)
        for i in range(len(self)):
            yield perm[i * self.batch_size:(i + 1) * self.batch_size].tolist()
