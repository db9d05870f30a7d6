"""CTAugment - FixMatch's control-theory augmentation policy learner.

Copied from ``mamba_unet_tpu/data/ctaugment.py``, not imported (any import
from ``mamba_unet_tpu`` runs its ``data`` package, which imports ``jax``),
and held bitwise equal to it for the same seed by the CPU tests. A registry
of PIL ops with per-magnitude-bin success rates; ``policy`` samples op
chains (uniform bins for probes, thresholded learned rates for training);
``update_rates`` decays each used bin toward the prediction-match
proximity. Strong ops are the first 9 registered (photometric + cutout),
weak ops the rest (geometric).

Host-side numpy/PIL; all randomness comes from an explicit
``np.random.Generator`` (``cutout``, the one stochastic op, takes the
generator through ``cta_apply``). The jigsaw grid-shuffle helpers come
with it.

The CTAugment algorithm (rate_to_p / policy / update_rates and the op
tables: 17 bins, 0.1 + 1.9 * level enhance range, strong/weak split at
index 9) originates in Google Research's FixMatch (Apache-2.0) and is
kept semantically identical, so learned policies transfer.
"""

from __future__ import annotations

import json
from collections import OrderedDict, namedtuple
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

OPS = OrderedDict()
OP = namedtuple("OP", ("f", "bins"))


def register(*bins):
    def wrap(f):
        OPS[f.__name__] = OP(f, bins)
        return f

    return wrap


def _enhance(x, op, level):
    return op(x).enhance(0.1 + 1.9 * level)


def _imageop(x, op, level):
    return Image.blend(x, op(x), level)


def _filter(x, op, level):
    return Image.blend(x, x.filter(op), level)


# --- strong (photometric) ops: indices 0..8 ---------------------------------


@register(17)
def autocontrast(x, level):
    return _imageop(x, ImageOps.autocontrast, level)


@register(17)
def brightness(x, level):
    return _enhance(x, ImageEnhance.Brightness, level)


@register(17)
def color(x, level):
    return _enhance(x, ImageEnhance.Color, level)


@register(17)
def contrast(x, level):
    return _enhance(x, ImageEnhance.Contrast, level)


@register(17)
def equalize(x, level):
    return _imageop(x, ImageOps.equalize, level)


@register(17)
def smooth(x, level):
    return _filter(x, ImageFilter.SMOOTH, level)


@register(17)
def blur(x, level):
    return _filter(x, ImageFilter.BLUR, level)


@register(17)
def sharpness(x, level):
    return _enhance(x, ImageEnhance.Sharpness, level)


@register(17)
def cutout(x, level, rng: Optional[np.random.Generator] = None):
    """Zero a random square of side ~level*min(size)/2 in the lower-right
    quadrant region (kept faithful to the reference's sampling :183-200).
    The only stochastic op: position comes from the explicit generator
    threaded through ``cta_apply`` (fresh OS-seeded one if absent)."""
    if rng is None:
        rng = np.random.default_rng()
    x = x.copy()
    size = 1 + int(level * min(x.size) * 0.499)
    img_height, img_width = x.size
    hl = int(rng.integers(img_height // 2, img_height))
    wl = int(rng.integers(img_height // 2, img_width))
    arr = np.array(x)
    r0, r1 = max(0, wl - size // 2), min(img_width, wl + size // 2)
    c0, c1 = max(0, hl - size // 2), min(img_height, hl + size // 2)
    arr[r0:r1, c0:c1] = 0
    return Image.fromarray(arr)


# --- weak (geometric) ops ----------------------------------------------------


@register()
def identity(x):
    return x


@register(17, 6)
def rescale(x, scale, method):
    s = x.size
    scale *= 0.25
    crop = (scale * s[0], scale * s[1], s[0] * (1 - scale), s[1] * (1 - scale))
    methods = (
        Image.LANCZOS, Image.BICUBIC, Image.BILINEAR, Image.BOX,
        Image.HAMMING, Image.NEAREST,
    )
    return x.crop(crop).resize(x.size, methods[int(method * 5.99)])


@register(17)
def rotate(x, angle):
    return x.rotate(int(np.round((2 * angle - 1) * 45)))


@register(17)
def shear_x(x, shear):
    shear = (2 * shear - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, shear, 0, 0, 1, 0))


@register(17)
def shear_y(x, shear):
    shear = (2 * shear - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, 0, shear, 1, 0))


@register(17)
def translate_x(x, delta):
    delta = (2 * delta - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, delta, 0, 1, 0))


@register(17)
def translate_y(x, delta):
    delta = (2 * delta - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, 0, 0, 1, delta))


N_STRONG_OPS = 9


class CTAugment:
    def __init__(self, depth: int = 2, th: float = 0.85, decay: float = 0.99,
                 seed: int = 0):
        self.depth = depth
        self.th = th
        self.decay = decay
        self.rng = np.random.default_rng(seed)
        self.rates = {
            k: tuple(np.ones(b, "f") for b in op.bins) for k, op in OPS.items()
        }

    def rate_to_p(self, rate: np.ndarray) -> np.ndarray:
        p = rate + (1 - self.decay)
        p = p / p.max()
        p[p < self.th] = 0
        return p

    def policy(self, probe: bool, weak: bool) -> List[OP]:
        keys = list(OPS.keys())
        kl = keys[N_STRONG_OPS:] if weak else keys[:N_STRONG_OPS]
        v = []
        for _ in range(self.depth):
            k = kl[self.rng.integers(len(kl))]
            bins = self.rates[k]
            rnd = self.rng.uniform(0, 1, len(bins))
            if probe:
                v.append(OP(k, rnd.tolist()))
                continue
            vt = []
            for r, b in zip(rnd, bins):
                p = self.rate_to_p(b)
                value = self.rng.choice(p.shape[0], p=p / p.sum())
                vt.append((value + r) / p.shape[0])
            v.append(OP(k, vt))
        return v

    def update_rates(self, policy: Sequence[OP], proximity: float) -> None:
        for k, bins in policy:
            for p, rate in zip(bins, self.rates[k]):
                i = int(p * len(rate) * 0.999)
                rate[i] = rate[i] * self.decay + proximity * (1 - self.decay)

    def stats(self) -> str:
        """Human-readable per-op thresholded-rate table (one op per line)."""
        lines = []
        for k in sorted(OPS.keys()):
            per_bin = " | ".join(
                ",".join(f"{x:.2f}" for x in self.rate_to_p(rate))
                for rate in self.rates[k]
            )
            lines.append(f"{k:<16s} {per_bin}")
        return "\n".join(lines)

    # StorableCTAugment (augmentations/__init__.py:7-20)
    def state_dict(self) -> OrderedDict:
        return OrderedDict(
            (k, getattr(self, k)) for k in ["decay", "depth", "th", "rates"]
        )

    def load_state_dict(self, state) -> None:
        for k in ["decay", "depth", "th", "rates"]:
            assert k in state, f"{k} not in {list(state.keys())}"
            setattr(self, k, state[k])


def get_default_cta(seed: int = 0) -> CTAugment:
    return CTAugment(seed=seed)


# ops whose result depends on randomness beyond their bin levels
_STOCHASTIC_OPS = frozenset({"cutout"})


def cta_apply(
    pil_img: Image.Image,
    ops: Optional[Sequence[OP]],
    rng: Optional[np.random.Generator] = None,
) -> Image.Image:
    if ops is None:
        return pil_img
    for op, args in ops:
        if op in _STOCHASTIC_OPS:
            pil_img = OPS[op].f(pil_img, *args, rng=rng)
        else:
            pil_img = OPS[op].f(pil_img, *args)
    return pil_img


def np_to_pil(img: np.ndarray) -> Image.Image:
    """float [0,1] grey (H, W) -> PIL 'L'."""
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))


def pil_to_np(img: Image.Image) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


# --- jigsaw grid shuffle (ctaugment.py:256-288) ------------------------------


def get_grid_shuffle_index(
    rng: np.random.Generator, image_shape: Sequence[int],
    grid_blocks: Tuple[int, int] = (4, 4),
):
    """Returns (flat pixel permutation (H, W), block permutation)."""
    x, y = image_shape[-2], image_shape[-1]
    assert x % grid_blocks[0] == 0 and y % grid_blocks[1] == 0
    bx, by = x // grid_blocks[0], y // grid_blocks[1]
    idx = np.arange(x * y).reshape(x, y)
    perm = rng.permutation(grid_blocks[0] * grid_blocks[1])
    grid = (
        idx.reshape(grid_blocks[0], bx, grid_blocks[1], by)
        .transpose(0, 2, 1, 3)
        .reshape(-1, bx, by)
    )
    shuffled = grid[perm]
    shuffle_index = (
        shuffled.reshape(grid_blocks[0], grid_blocks[1], bx, by)
        .transpose(0, 2, 1, 3)
        .reshape(x, y)
    )
    return shuffle_index, perm


def grid_shuffle_image(image: np.ndarray, shuffle_index: np.ndarray) -> np.ndarray:
    """Apply a flat pixel permutation to (H, W) or (B, H, W)."""
    shape = image.shape
    flat = image.reshape(-1, shape[-2] * shape[-1]) if image.ndim > 2 else \
        image.reshape(1, -1)
    out = flat[:, shuffle_index.reshape(-1)]
    return out.reshape(shape)
