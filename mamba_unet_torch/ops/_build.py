"""Build and load the port's CUDA kernels.

The sources under ``mamba_unet_torch/csrc/`` have a plain C interface. At
first use each is compiled with its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library under
``build/mamba_unet_torch/`` at the repository root, named by a hash of the
sources (an edited source builds anew), and loaded with ``ctypes``. A missing ``nvcc`` or a failed build raises with the compiler's
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
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; every entry returns cudaError_t as an int.
_SIGNATURES = {
    # u2, delta4, B4, C4, A, D, delta_bias, out, cs (or null),
    # batch, L, dg, n, is_bf16, stream
    "selective_scan_bidir_fwd": [_P] * 9 + [_I] * 5 + [_P],
    # u2, delta4, B4, C4, A, D, delta_bias, cs, gy,
    # du2, ddelta4, dB_part, dC_part, dA_part, dD_part, ddb_part,
    # batch, L, dg, n, is_bf16, stream
    "selective_scan_bidir_bwd": [_P] * 16 + [_I] * 5 + [_P],
    # batch, L, dg, is_bf16, save, out (int[9]): grid x/y/z, threads,
    # registers, static and dynamic shared memory, local bytes, blocks/SM
    "selective_scan_bidir_fwd_occupancy": [_I] * 5 + [_P],
    # batch, L, dg, is_bf16, out (int[9]) as above
    "selective_scan_bidir_bwd_occupancy": [_I] * 4 + [_P],
    # u, delta, B, C, A, D, delta_bias, x_init (or null), y, last_state
    # (or null), cs (or null), batch, G, L, dg, n, softplus, is_bf16, stream
    "selective_scan_fwd": [_P] * 11 + [_I] * 7 + [_P],
    # u, delta, B, C, A, D, delta_bias, cs, gy,
    # du, ddelta, dB_part, dC_part, dA_part, dD_part, ddb_part,
    # g_last (or null), dx_init (or null),
    # batch, G, L, dg, n, softplus, is_bf16, stream
    "selective_scan_bwd": [_P] * 18 + [_I] * 7 + [_P],
    # batch, G, L, dg, is_bf16, save, out (int[9]) as the bidir occupancy
    "selective_scan_fwd_occupancy": [_I] * 6 + [_P],
    # batch, G, L, dg, is_bf16, out (int[9]) as the bidir occupancy
    "selective_scan_bwd_occupancy": [_I] * 5 + [_P],
    # u, delta, B, C (batch-major), A, D, delta_bias, y, cs (or null),
    # batch, G, L, dg, n, bidir, softplus, is_bf16, stream
    "selective_scan_folded_fwd": [_P] * 9 + [_I] * 8 + [_P],
    # u, delta, B, C, A, D, delta_bias, cs, gy,
    # du (fp32, S streams), ddelta, dB_part, dC_part, dA_part, dD_part,
    # ddb_part,
    # batch, G, L, dg, n, bidir, softplus, is_bf16, stream
    "selective_scan_folded_bwd": [_P] * 16 + [_I] * 8 + [_P],
    # batch, G, L, dg, is_bf16, save, out (int[9]) as the bidir occupancy
    "selective_scan_folded_fwd_occupancy": [_I] * 6 + [_P],
    # batch, G, L, dg, bidir, is_bf16, out (int[9]) as the bidir occupancy
    "selective_scan_folded_bwd_occupancy": [_I] * 6 + [_P],
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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands all at once; raise with the output of any that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    lib = BUILD_DIR / f"libkernels-{_source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename the library into place, so
    # a concurrent or cut-off build never leaves a partial library under
    # the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        nvcc = _nvcc()
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
        out = Path(tmp) / lib.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(out),
               *map(str, objs)]])
        os.replace(out, lib)
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
