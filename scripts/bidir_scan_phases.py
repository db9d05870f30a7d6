#!/usr/bin/env python3
"""Where the bidirectional scan kernels spend their time, phase by phase.

Builds copies of ``csrc/selective_scan_bidir_fwd.cu`` and ``_bwd.cu`` with
``clock64()`` read at the boundaries of each phase of their chunk loop,
runs them at the stage-0 and stage-1 shapes of the 224² model (bs24, fp32
inputs), and prints, per kernel and shape, the cycles the first thread of
each direction group spent in each phase, averaged over the blocks, and
their share. Needs a CUDA card and ``nvcc``; imports nothing of JAX.

    python3 scripts/bidir_scan_phases.py

Forward phases: issuing the next chunk's loads, the scan, the barrier, the
pair-merged write-out of y, converting the next chunk into shared memory,
the barrier. Backward phases: the du prefetch and the ``cp.async`` copies of
the next chunk, the recompute and reverse of the chunk, the barrier, the
write-out (dΔ, du, dB/dC), waiting for the copies and converting them, the
barrier. The reads of the clock cost a few cycles each; the totals are
within a few percent of the kernels' own times.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = ((3136, 192), (784, 384))  # (L, dg) of stages 0 and 1
BATCH = 24
MAX_BLOCKS = 8192
HEADER = """__device__ long long g_phase_cycles[%d][8];
extern "C" int phase_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles,
                                   sizeof(g_phase_cycles));
}
namespace {""" % MAX_BLOCKS
SAVE = ("    acc[0] += T1 - T0; acc[1] += T2 - T1; acc[2] += T3 - T2;\n"
        "    acc[3] += T4 - T3; acc[4] += T5 - T4; acc[5] += T6 - T5;\n"
        "  }\n"
        "  if (gt == 0) {\n"
        "    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) *"
        " gridDim.x + blockIdx.x;\n"
        "    for (int j = 0; j < 6; ++j) g_phase_cycles[blk * 2 + r][j] ="
        " acc[j];\n"
        "  }\n")
PHASES = {
    "fwd": ("load_issue", "scan", "barrier", "writeout", "convert",
            "barrier2"),
    "bwd": ("prefetch_stage", "recompute_reverse", "barrier", "writeout",
            "wait_convert", "barrier2"),
}


def tick(n: int) -> str:
    return f"    const long long T{n} = clock64();\n"


def instrument(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"anchor not found in the kernel source:\n{old}")
        src = src.replace(old, new, 1)
    return src


def fwd_source() -> str:
    src = (ROOT / "mamba_unet_torch/csrc/selective_scan_bidir_fwd.cu"
           ).read_text()
    loop = "  for (int i = 0; i < nch; ++i) {\n"
    load = ("    if (i + 1 < nch) load(st, i + 1);  // in flight during the "
            "scan\n")
    sync = ("    __syncthreads();  // both groups' y of this iteration are in "
            "smem\n")
    tail = ("    if (i + 1 < nch) convert(st, i + 1);\n"
            "    __syncthreads();\n  }\n")
    return instrument(src, [
        ("namespace {", HEADER),
        (loop, "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n" + loop + tick(0)),
        (load, load + tick(1)),
        (sync, tick(2) + sync + tick(3)),
        (tail, tick(4) + "    if (i + 1 < nch) convert(st, i + 1);\n"
         + tick(5) + "    __syncthreads();\n" + tick(6) + SAVE),
    ])


def bwd_source() -> str:
    src = (ROOT / "mamba_unet_torch/csrc/selective_scan_bidir_bwd.cu"
           ).read_text()
    loop = "  for (int i = 0; i < nc; ++i) {\n"
    stage = ("    if (i + 1 < nc) stage(i + 1);  // in flight during this "
             "chunk\n")
    sync = ("    __syncthreads();  // both groups' outputs of this iteration "
            "are in smem\n")
    tail = ("    if (i + 1 < nc) {\n      cp_async_wait_all();\n"
            "      __syncthreads();  // every thread's copies of the next "
            "chunk landed\n      convert(i + 1);\n    }\n"
            "    __syncthreads();\n  }\n")
    return instrument(src, [
        ("namespace {", HEADER),
        (loop, "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n" + loop + tick(0)),
        (stage, stage + tick(1)),
        (sync, tick(2) + sync + tick(3)),
        (tail, tick(4) + tail.replace("    __syncthreads();\n  }\n", "")
         + tick(5) + "    __syncthreads();\n" + tick(6) + SAVE),
    ])


def build(src: str, tmp: Path, name: str):
    from mamba_unet_torch.ops import _build

    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"selective_scan_bidir_{name}")
    fn.argtypes = _build._SIGNATURES[f"selective_scan_bidir_{name}"]
    fn.restype = ctypes.c_int
    lib.phase_cycles.argtypes = [ctypes.c_void_p]
    lib.phase_cycles.restype = ctypes.c_int
    return fn, lib.phase_cycles


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bidir_scan_phases: needs a CUDA card")
    import chip_smoke
    from mamba_unet_torch.ops import selective_scan_bidir as ssb

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"fwd": build(fwd_source(), Path(tmp), "fwd"),
                   "bwd": build(bwd_source(), Path(tmp), "bwd")}
        for L, dg in SHAPES:
            args = chip_smoke.scan_inputs(torch, BATCH, L, dg,
                                          torch.float32, dev, 0)
            u2, d4, A, B4, C4, D, db = args
            gy = torch.randn(BATCH, 2, L, dg, generator=torch.Generator()
                             .manual_seed(1)).to(dev)
            _, cs = ssb.selective_scan_bidir_fwd_states(*args)
            f32 = dict(dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            ntile = -(-dg // ssb.KERNEL_TILE)
            blocks = 2 * BATCH * ntile
            out = torch.empty(u2.shape, **f32)
            grads = [torch.empty(u2.shape, **f32), torch.empty_like(d4),
                     torch.empty(ntile, BATCH, 4, L, 16, **f32),
                     torch.empty(ntile, BATCH, 4, L, 16, **f32),
                     torch.empty(BATCH, 4 * dg, 16, **f32),
                     torch.empty(BATCH, 4 * dg, **f32),
                     torch.empty(BATCH, 4 * dg, **f32)]
            ptrs = [t.data_ptr() for t in (u2, d4, B4, C4, A, D, db)]
            calls = {
                "fwd": lambda f: f(*ptrs, out.data_ptr(), None, BATCH, L,
                                   dg, 16, 0, stream),
                "bwd": lambda f: f(*ptrs, cs.data_ptr(), gy.data_ptr(),
                                   *[t.data_ptr() for t in grads], BATCH, L,
                                   dg, 16, 0, stream),
            }
            for kind, (fn, read) in kernels.items():
                ms, err = chip_smoke.cuda_ms(torch, lambda: calls[kind](fn),
                                             5)
                if err:
                    raise SystemExit(f"{kind} launch failed: {err}")
                buf = (ctypes.c_longlong * (MAX_BLOCKS * 8))()
                torch.cuda.synchronize()
                if read(buf):
                    raise SystemExit("reading the phase counters failed")
                cyc = torch.tensor(list(buf), dtype=torch.float64).reshape(
                    MAX_BLOCKS, 8)[:2 * blocks, :6].mean(0)
                total = cyc.sum().item()
                print(f"[phases] kernel={kind} L={L} dg={dg} batch={BATCH} "
                      f"ms={ms:.4f} cycles_per_group={total:.0f} " + " ".join(
                          f"{name}={100 * c / total:.1f}%" for name, c in
                          zip(PHASES[kind], cyc.tolist())), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
