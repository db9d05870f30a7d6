"""MagicNet's cube machinery: cross-batch cube shuffle and recovery,
per-image cube lists, location labels, and the class-distribution logger.

Port of ``mamba_unet_tpu/objectives/cube.py``. Channels-last and
rank-generic: (B, *spatial, C) with 2 or 3 spatial axes; the cube grid
must tile the image exactly. A cube list is (B, P, *cube, C) with the
cube index ordered first-spatial-axis fastest, as the reference's location
ids (loc = x + sx * y + sx * sy * z). Where the JAX functions take a PRNG
key, these take a ``torch.Generator``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def _to_cubes(x: torch.Tensor, nb: int) -> Tuple[torch.Tensor, list]:
    """(B, *spatial, C) -> (B, n1..nk, c1..ck, C), cube axes leading."""
    spatial = x.shape[1:-1]
    k = len(spatial)
    if any(s % nb for s in spatial):
        raise ValueError(f"a {nb}-cube grid does not tile {tuple(x.shape)}")
    cs = [s // nb for s in spatial]
    shape = [x.shape[0]]
    for c in cs:
        shape += [nb, c]
    x = x.reshape(*shape, x.shape[-1])
    perm = ([0] + [1 + 2 * i for i in range(k)]
            + [2 + 2 * i for i in range(k)] + [1 + 2 * k])
    return x.permute(*perm), cs


def _from_cubes(x: torch.Tensor, nb: int, spatial_rank: int) -> torch.Tensor:
    """Inverse of :func:`_to_cubes`."""
    k = spatial_rank
    inv = [0]
    for i in range(k):
        inv += [1 + i, 1 + k + i]
    inv += [1 + 2 * k]
    x = x.permute(*inv)
    spatial = [x.shape[1 + 2 * i] * x.shape[2 + 2 * i] for i in range(k)]
    return x.reshape(x.shape[0], *spatial, x.shape[-1])


def cube_shuffle_indices(generator: Optional[torch.Generator], batch: int,
                         nb: int, rank: int, device=None):
    """A random batch permutation per cube position and its inverse,
    both (B, nb, ..., nb)."""
    u = torch.rand((batch,) + (nb,) * rank, generator=generator,
                   device=device)
    part = u.argsort(dim=0)
    return part, part.argsort(dim=0)


def apply_cube_permutation(x: torch.Tensor, perm: torch.Tensor, nb: int
                           ) -> torch.Tensor:
    """Shuffle cubes across the batch: out[b, cube p] = x[perm[b, p],
    cube p]."""
    rank = x.dim() - 2
    cubes, _ = _to_cubes(x, nb)
    idx = perm.reshape(perm.shape + (1,) * (rank + 1)).expand(cubes.shape)
    return _from_cubes(torch.gather(cubes, 0, idx), nb, rank)


def get_patch_list(x: torch.Tensor, cube_size: int) -> torch.Tensor:
    """(B, *spatial, C) -> (B, P, *cube, C), P = prod(spatial //
    cube_size), the first spatial axis fastest."""
    rank = x.dim() - 2
    nb = x.shape[1] // cube_size
    cubes, _ = _to_cubes(x, nb)
    axes = ([0] + list(range(rank, 0, -1))
            + list(range(rank + 1, cubes.dim())))
    cubes = cubes.permute(*axes)
    return cubes.reshape(cubes.shape[0], nb ** rank,
                         *cubes.shape[rank + 1:])


def unmix_patches(patches: torch.Tensor, nb: int) -> torch.Tensor:
    """Inverse of :func:`get_patch_list`."""
    rank = patches.dim() - 3
    cubes = patches.reshape(patches.shape[0], *(nb,) * rank,
                            *patches.shape[2:])
    inv = ([0] + list(range(rank, 0, -1))
           + list(range(rank + 1, cubes.dim())))
    return _from_cubes(cubes.permute(*inv), nb, rank)


def random_permutations(generator: Optional[torch.Generator], batch: int,
                        n: int, device=None) -> torch.Tensor:
    """(B, n): an independent random permutation of range(n) per row."""
    return torch.rand(batch, n, generator=generator,
                      device=device).argsort(dim=1)


def shuffled_location_labels(generator: Optional[torch.Generator],
                             batch: int, n_cubes: int, device=None
                             ) -> torch.Tensor:
    """A per-sample random permutation of cube slots: sample i's cube at
    slot j came from location perms[i, j], the target of the
    cube-location task."""
    return random_permutations(generator, batch, n_cubes, device)


def shuffle_within_sample(patches: torch.Tensor, perms: torch.Tensor
                          ) -> torch.Tensor:
    """Reorder each sample's cube list by ``perms`` (B, P)."""
    idx = perms.reshape(perms.shape + (1,) * (patches.dim() - 2))
    return torch.gather(patches, 1, idx.expand(patches.shape))


class OrganClassLogger:
    """Class-distribution store: collect pseudo-label class ids, and
    recompute the histogram on demand."""

    def __init__(self, num_classes: int = 14):
        self.num_classes = num_classes
        self.class_dist = np.zeros(num_classes, np.float64)
        self._store: List[np.ndarray] = []

    def append_class_list(self, labels) -> None:
        if isinstance(labels, torch.Tensor):
            labels = labels.detach().cpu().numpy()
        self._store.append(np.asarray(labels).reshape(-1))

    def update_class_dist(self) -> None:
        if not self._store:
            return
        allv = np.concatenate(self._store)
        self.class_dist = np.bincount(
            allv.astype(np.int64), minlength=self.num_classes
        ).astype(np.float64)
        self._store = []

    def get_class_dist(self, normalize: bool = False) -> np.ndarray:
        d = self.class_dist.copy()
        if normalize and d.sum() > 0:
            d = d / d.sum()
        return d
