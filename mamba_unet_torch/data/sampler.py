"""Batch index samplers.

Copied from ``EpochShuffleSampler`` and ``TwoStreamBatchSampler`` in
``mamba_unet_tpu/data/sampler.py``, with the same numpy ``default_rng(seed)``
streams, so the port yields the same index batches. A two-stream batch is
``batch_size - secondary_batch_size`` labeled indices (shuffled, each seen
once per epoch) followed by ``secondary_batch_size`` unlabeled ones
(shuffled without end).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence

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


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, seed: int = 0):
        self.primary = list(primary_indices)
        self.secondary = list(secondary_indices)
        self.secondary_bs = secondary_batch_size
        self.primary_bs = batch_size - secondary_batch_size
        assert len(self.primary) >= self.primary_bs > 0
        assert len(self.secondary) >= self.secondary_bs > 0
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.primary) // self.primary_bs

    def _eternal(self) -> Iterator[int]:
        while True:
            yield from self.rng.permutation(self.secondary).tolist()

    def __iter__(self) -> Iterator[List[int]]:
        primary = iter(self.rng.permutation(self.primary).tolist())
        secondary = self._eternal()
        while True:
            batch = list(itertools.islice(primary, self.primary_bs))
            if len(batch) < self.primary_bs:
                return
            batch += list(itertools.islice(secondary, self.secondary_bs))
            yield batch
