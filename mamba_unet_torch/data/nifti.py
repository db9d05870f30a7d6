"""Minimal NIfTI-1 I/O, numpy only.

A copy of ``mamba_unet_tpu/data/nifti.py`` (``read_nifti``,
``write_nifti``), not imported: any import from ``mamba_unet_tpu`` runs its
``data`` package, which imports ``jax``. The test CLI writes its
predictions with it (``--save_nii_dir``: uint8 volumes at spacing
(1, 1, 10)).

Single-file NIfTI-1 (.nii / .nii.gz): 348-byte header, vox_offset 352,
dtypes uint8/int16/int32/float32/float64 (and int8/uint16/uint32), sform
spacing on the diagonal, Fortran (column-major) data order per the spec.
"""

from __future__ import annotations

import gzip
import struct
from typing import Sequence, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (data array, pixdim[1:4] spacing). Applies scl slope/inter."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not little-endian NIfTI-1")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        magic = hdr[344:348]
        if not magic.startswith(b"n+1") and not magic.startswith(b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        ndim = dim[0]
        shape = dim[1 : 1 + ndim]
        dtype = _DTYPES.get(datatype)
        if dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        f.read(max(vox_offset - 348, 0))
        raw = f.read(int(np.prod(shape)) * np.dtype(dtype).itemsize)
    data = np.frombuffer(raw, dtype=dtype).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    return data, np.asarray(pixdim[1:4], np.float32)


def write_nifti(
    path: str,
    data: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> None:
    """Write ``data`` as single-file NIfTI-1 with diagonal sform = spacing."""
    data = np.asarray(data)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = 16
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pixdim = [1.0] + list(spacing)[:ndim] + [1.0] * (7 - ndim)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = scanner
    sp = list(spacing) + [1.0] * 3
    struct.pack_into("<4f", hdr, 280, sp[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, sp[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, sp[2], 0)  # srow_z
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # pad to vox_offset 352
        f.write(np.asfortranarray(data).tobytes(order="F"))
