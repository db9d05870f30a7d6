"""Shuffle/mask recovery inputs and loss of the mask-pretraining pipeline.

Port of ``mamba_unet_tpu/objectives/masked.py``: the shuffled recovery is
the MSE between the clean global embedding and that of the image with its
cubes shuffled, given the shuffle ids; the mask recovery the MSE against
the image with about a quarter of its cubes blanked, given the visibility
mask. The caller applies the model's ``forward_mix_pos_mask``. The draws
come from an explicit ``torch.Generator``, or are handed in (``perms``,
``vis``), as the tests hand in JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from mamba_unet_torch.nn.layers import at_least_fp32
from mamba_unet_torch.objectives.cube import (
    get_patch_list,
    random_permutations,
    shuffle_within_sample,
    unmix_patches,
)
from mamba_unet_torch.objectives.losses import batch_mean


def make_shuffled_input(image: torch.Tensor, cube_size: int,
                        generator: Optional[torch.Generator] = None,
                        perms: Optional[torch.Tensor] = None):
    """(image with each sample's cubes shuffled, the shuffle ids (B, P)):
    slot j holds the cube from location perms[b, j]."""
    b = image.shape[0]
    nb = image.shape[1] // cube_size
    if perms is None:
        perms = random_permutations(generator, b, nb * nb, image.device)
    patches = shuffle_within_sample(get_patch_list(image, cube_size),
                                    perms.to(image.device).long())
    return unmix_patches(patches, nb), perms


def make_masked_input(image: torch.Tensor, cube_size: int,
                      masked_rate: float = 0.25, fill: float = 1e-6,
                      generator: Optional[torch.Generator] = None,
                      vis: Optional[torch.Tensor] = None):
    """(image with its masked cubes set to ``fill``, the visibility mask
    (B, P): 1 = kept, each cube blanked with probability
    ``masked_rate``)."""
    b = image.shape[0]
    nb = image.shape[1] // cube_size
    if vis is None:
        u = torch.rand(b, nb * nb, generator=generator, device=image.device)
        vis = (u > masked_rate).float()
    patches = get_patch_list(image, cube_size)
    keep = vis.to(image.device, patches.dtype).reshape(
        b, nb * nb, *([1] * (patches.dim() - 2)))
    patches = patches * keep + fill * (1.0 - keep)
    return unmix_patches(patches, nb), vis


def recovery_mse(clean_embed: torch.Tensor, perturbed_embed: torch.Tensor,
                 group=None) -> torch.Tensor:
    """The mean squared difference, in fp32 (fp64 for fp64 embeddings;
    over ``group``'s global batch when given)."""
    return batch_mean((at_least_fp32(clean_embed)
                       - at_least_fp32(perturbed_embed)) ** 2, group)
