"""ctypes bindings for the native (C++) host augmentation.

Port of ``mamba_unet_tpu/data/native.py``, with a copy of its C++ source
(``mamba_unet_torch/native/augment.cpp``). The library is built with
``g++`` at first use into ``build/mamba_unet_torch/`` at the repository
root (named by a hash of the source, so an edited source builds anew),
not next to the source. ctypes calls release the GIL, so the native
augmentation runs beside the training loop.

Where the JAX module degrades silently to the scipy transform when no
compiler is found, this one raises: ``available()`` says whether the
library builds, and the functions and :class:`NativeRandomGenerator`
raise with the compiler's error when it does not (the port has no
fallback that hides what ran).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "augment.cpp"
BUILD_DIR = _PKG.parent / "build" / "mamba_unet_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_I = ctypes.c_int


def build() -> Path:
    """Compile ``augment.cpp`` with g++ unless a library for this source
    exists; raise with the compiler's output when it fails."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libaugment-{digest}.so"
    if lib.is_file():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native augmentation cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(out)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for dtype_p, tag in ((_f32p, "f32"), (_i64p, "i64")):
        fn = getattr(lib, f"nn_zoom_{tag}")
        fn.argtypes = [dtype_p, _I, _I, dtype_p, _I, _I]
        fn.restype = None
        fn = getattr(lib, f"rot90_flip_{tag}")
        fn.argtypes = [dtype_p, _I, _I, _I, _I, dtype_p]
        fn.restype = None
    lib.augment_slice.argtypes = [_f32p, _i64p, _I, _I, _I, _I, _I, _f32p,
                                  _i64p, _I, _I]
    lib.augment_slice.restype = None
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _typed(arr: np.ndarray):
    """(contiguous float32 or int64 copy, pointer type, suffix)."""
    if arr.dtype == np.float32:
        return np.ascontiguousarray(arr), _f32p, "f32"
    return np.ascontiguousarray(arr, np.int64), _i64p, "i64"


def nn_zoom(arr: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """scipy.ndimage.zoom(order=0)-exact nearest resize of a 2-D array
    (float32, or integers as int64), native."""
    src, ptr, tag = _typed(arr)
    h, w = src.shape
    oh, ow = out_shape
    out = np.empty((oh, ow), src.dtype)
    getattr(library(), f"nn_zoom_{tag}")(src.ctypes.data_as(ptr), h, w,
                                         out.ctypes.data_as(ptr), oh, ow)
    return out


def rot90_flip(arr: np.ndarray, k: int, axis: int) -> np.ndarray:
    """``np.flip(np.rot90(arr, k), axis)`` of a 2-D array, native."""
    src, ptr, tag = _typed(arr)
    h, w = src.shape
    out = np.empty((w, h) if k % 2 else (h, w), src.dtype)
    getattr(library(), f"rot90_flip_{tag}")(src.ctypes.data_as(ptr), h, w,
                                            k, axis, out.ctypes.data_as(ptr))
    return out


class NativeRandomGenerator:
    """``data.augment.RandomGenerator`` with the hot path (rot90 + flip +
    order-0 zoom) fused in C++; the 25 %-branch ±20° rotate stays on
    scipy. For one seed it draws the same numbers as the JAX package's
    native generator and gives the same arrays. The library is built when
    the generator is made (raises where it cannot be)."""

    def __init__(self, output_size: Sequence[int], seed: int = 0):
        self.output_size = tuple(output_size)
        self.rng = np.random.default_rng(seed)
        self._lib = library()

    def __call__(self, sample):
        from scipy import ndimage

        image = np.ascontiguousarray(sample["image"], np.float32)
        label = np.ascontiguousarray(sample["label"], np.int64)
        do_rotflip = 0
        k = axis = 0
        if self.rng.random() > 0.5:
            do_rotflip = 1
            k = int(self.rng.integers(0, 4))
            axis = int(self.rng.integers(0, 2))
        elif self.rng.random() > 0.5:
            angle = int(self.rng.integers(-20, 20))
            image = np.ascontiguousarray(
                ndimage.rotate(image, angle, order=0, reshape=False))
            label = np.ascontiguousarray(
                ndimage.rotate(label, angle, order=0, reshape=False))
        h, w = image.shape
        oh, ow = self.output_size
        out_img = np.empty((oh, ow), np.float32)
        out_lab = np.empty((oh, ow), np.int64)
        self._lib.augment_slice(
            image.ctypes.data_as(_f32p), label.ctypes.data_as(_i64p), h, w,
            do_rotflip, k, axis,
            out_img.ctypes.data_as(_f32p), out_lab.ctypes.data_as(_i64p),
            oh, ow,
        )
        return {"image": out_img[..., None], "label": out_lab}
