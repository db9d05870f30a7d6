"""Synthetic cardiac-like phantom slices and volumes, in memory.

``_phantom`` is the phantom of ``mamba_unet_tpu/data/synthetic.py`` (class 1
RV-like crescent, class 2 myocardium-like ring, class 3 LV-like disk on a
noisy background), copied rather than imported because the JAX package's
``data`` package imports ``jax``. It takes a height and a width, so slices
can have ACDC's non-square native size; for a square slice it draws the
same numbers as the JAX version. ``_phantom_hard`` is that module's
discriminating phantom (wobbly boundaries, overlapping intensities under a
bias field, distractor blobs, apical slices without RV), copied the same
way.

:func:`phantom_acdc` is the in-memory counterpart of that module's
``make_synthetic_acdc`` (``hard`` too): the same splits, drawn in the same
order from one seed, so for square slices it holds the same arrays that
function writes to h5. Nothing is written: the machine with the card has
no ``h5py``. With ``scribble`` every train slice also carries the sparse
label that function writes as ``scribble`` (``data/scribble.py``), drawn
from the same generator right after its slice, as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mamba_unet_torch.data.scribble import scribbles_from_mask


def _phantom(rng: np.random.Generator, h: int, w: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    size = min(h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h / 8, h / 8)
    cx = w / 2 + rng.uniform(-w / 8, w / 8)
    r = np.hypot(yy - cy, xx - cx)
    r_lv = size * rng.uniform(0.06, 0.10)
    r_myo = r_lv + size * rng.uniform(0.04, 0.07)
    label = np.zeros((h, w), np.uint8)
    label[r < r_myo] = 2  # myocardium ring
    label[r < r_lv] = 3  # LV blood pool
    # RV: a crescent left of the LV
    rv_cx = cx - r_myo * rng.uniform(1.1, 1.5)
    rv = np.hypot(yy - cy, xx - rv_cx) < r_myo * rng.uniform(0.7, 1.0)
    label[rv & (label == 0)] = 1
    image = 0.2 + 0.15 * rng.standard_normal((h, w)).astype(np.float32)
    image += 0.3 * (label == 1) + 0.5 * (label == 2) + 0.9 * (label == 3)
    image = np.clip(image, 0, 1).astype(np.float32)
    return image, label


def _phantom_hard(rng: np.random.Generator, h: int, w: int,
                  apical: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The discriminating phantom: wobbly class boundaries (an angular
    Fourier perturbation), class intensities that overlap under a smooth
    bias field and correlated noise, 2-4 distractor blobs with class-like
    intensities but background label, and with ``apical`` no RV."""
    from scipy.ndimage import gaussian_filter

    size = min(h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h / 6, h / 6)
    cx = w / 2 + rng.uniform(-w / 6, w / 6)
    dy, dx = yy - cy, xx - cx
    r = np.hypot(dy, dx)
    th = np.arctan2(dy, dx)

    def wobble():
        out = np.ones_like(th)
        for k in range(2, 6):
            out += rng.uniform(0.0, 0.18) * np.sin(k * th + rng.uniform(0, 7))
        return out

    r_lv = size * rng.uniform(0.06, 0.11) * wobble()
    r_myo = r_lv + size * rng.uniform(0.035, 0.08) * wobble()
    label = np.zeros((h, w), np.uint8)
    label[r < r_myo] = 2
    label[r < r_lv] = 3
    if not apical:
        rv_cx = cx - np.mean(r_myo) * rng.uniform(1.1, 1.6)
        rv_cy = cy + rng.uniform(-h / 10, h / 10)
        rv_r = np.mean(r_myo) * rng.uniform(0.6, 1.1) * wobble()
        rv = np.hypot(yy - rv_cy, xx - rv_cx) < rv_r
        label[rv & (label == 0)] = 1

    # overlapping intensities: class means closer together, per-slice jitter
    means = np.array([0.25, 0.45, 0.55, 0.75]) + rng.uniform(-0.06, 0.06, 4)
    image = means[label].astype(np.float32)
    # distractor blobs in the background with class-like intensities
    for _ in range(rng.integers(2, 5)):
        bx, by = rng.uniform(0, w), rng.uniform(0, h)
        br = size * rng.uniform(0.03, 0.09)
        blob = np.hypot(yy - by, xx - bx) < br
        image[blob & (label == 0)] = rng.choice(means[1:])
    # smooth multiplicative bias field + correlated + white noise
    bias = gaussian_filter(rng.standard_normal((h, w)), size / 6)
    bias = 1.0 + 0.35 * bias / (np.abs(bias).max() + 1e-6)
    tex = gaussian_filter(rng.standard_normal((h, w)), 1.5).astype(np.float32)
    image = image * bias + 0.35 * tex + 0.10 * rng.standard_normal((h, w))
    image = np.clip(image, 0, 1.6).astype(np.float32) / 1.6
    return image, label


def _slice(rng: np.random.Generator, h: int, w: int, s: int, n_slices: int,
           hard: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Slice ``s`` of a case of ``n_slices``: with ``hard`` the hard
    phantom, apical (no RV) from 70 % of the case on."""
    if hard:
        return _phantom_hard(rng, h, w, apical=s >= 0.7 * n_slices)
    return _phantom(rng, h, w)


def _volumes(rng: np.random.Generator, prefix: str, n_cases: int,
             n_slices: int, h: int, w: int, hard: bool = False
             ) -> List[Dict[str, np.ndarray]]:
    vols = []
    for c in range(n_cases):
        pairs = [_slice(rng, h, w, s, n_slices, hard)
                 for s in range(n_slices)]
        vols.append({
            "image": np.stack([p[0] for p in pairs]),
            "label": np.stack([p[1] for p in pairs]).astype(np.int64),
            "case": f"{prefix}{c:03d}",
        })
    return vols


def phantom_volumes(n_cases: int, n_slices: int, h: int, w: int,
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n_cases`` volumes as ``VolumeDataset`` items: ``image`` (Z, h, w)
    float32, ``label`` (Z, h, w) int64, ``case``."""
    return _volumes(np.random.default_rng(seed), "phantom", n_cases,
                    n_slices, h, w)


def phantom_acdc(n_train_cases: int = 4, slices_per_case: int = 4,
                 n_val_cases: int = 2, n_test_cases: int = 0, h: int = 64,
                 w: Optional[int] = None, seed: int = 0, hard: bool = False,
                 scribble: bool = False
                 ) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """In-memory ACDC-format splits: ``train`` is a list of slices
    (``image`` (h, w) float32, ``label`` (h, w) int64, and with
    ``scribble`` ``scribble`` (h, w) int64, 4 where unlabeled), in the
    order of ``train_slices.list``; ``val`` and ``test`` are
    ``VolumeDataset`` items of ``slices_per_case`` slices each, dense
    labels only. ``hard`` draws the hard phantom, its last 30 % of each
    case's slices apical."""
    w = h if w is None else w
    rng = np.random.default_rng(seed)
    train = []
    for i in range(n_train_cases * slices_per_case):
        image, label = _slice(rng, h, w, i % slices_per_case,
                              slices_per_case, hard)
        train.append({"image": image, "label": label.astype(np.int64)})
        if scribble:
            train[-1]["scribble"] = scribbles_from_mask(label, rng).astype(
                np.int64)
    val = _volumes(rng, "val_patient", n_val_cases, slices_per_case, h, w,
                   hard)
    test = _volumes(rng, "test_patient", n_test_cases, slices_per_case, h, w,
                    hard)
    return {"train": train, "val": val, "test": test}
