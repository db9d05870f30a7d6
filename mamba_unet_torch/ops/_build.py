"""Build and load the port's CUDA kernels.

The sources under ``mamba_unet_torch/csrc/`` have a plain C interface. At
first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``build/mamba_unet_torch/`` at the repository root, named by a
hash of the sources (an edited source builds anew), and loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises with the compiler's
output; nothing falls back.
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

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mamba_unet_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; every entry returns cudaError_t as an int.
_SIGNATURES = {
    # u2, delta4, B4, C4, A, D, delta_bias, out, batch, L, dg, n, is_bf16, stream
    "selective_scan_bidir_fwd": [_P] * 8 + [_I] * 5 + [_P],
}


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_hash() -> str:
    """Hash of the flags and of every file under csrc/ (headers too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    sources = _sources()
    lib = BUILD_DIR / f"libkernels-{_source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename, so a concurrent or cut-off
    # build never leaves a partial library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
