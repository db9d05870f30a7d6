#!/usr/bin/env python3
"""Where the scan kernels spend their time, phase by phase.

Builds copies of ``csrc/selective_scan_bidir_fwd.cu`` and ``_bwd.cu``, of
the grouped and folded backwards (``csrc/selective_scan_bwd.cu``,
``csrc/selective_scan_folded_bwd.cu``, whose chunk loop is the shared body
in ``csrc/selective_scan_bwd_group.cuh``) and of the grouped and folded
forwards (``csrc/selective_scan_fwd.cu``, ``csrc/selective_scan_folded_fwd.cu``,
on the body in ``csrc/selective_scan_fwd_group.cuh``), with ``clock64()``
read at the boundaries of each phase of their chunk loop, runs them at the
stage-0 and stage-1 shapes of the 224² model (bs24, fp32 inputs; the
grouped kernels with G = 4, the folded ones bidirectional; the grouped
forward state-saving, the folded one serving and state-saving), and the
grouped serving forward at a mamba-130m scoring call's shape (batch 8,
L = 1024, dg = 1536), and prints, per kernel and shape, the cycles the first thread of each 64-thread
group spent in each phase, averaged over the blocks, and their share.
Needs a CUDA card and ``nvcc``; imports nothing of JAX.

    python3 scripts/scan_phases.py

Bidirectional forward phases: issuing the next chunk's loads, the scan,
the barrier, the pair-merged write-out of y, converting the next chunk into
shared memory, the barrier. Grouped and folded forward phases: issuing the
next chunk's ``cp.async`` copies, the scan, waiting for the copies at the
barrier, the write-out of y (and cs), converting the next chunk, the
barrier. Backward phases: the du prefetch and the ``cp.async`` copies of
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
LM_SHAPE = (8, 1024, 1536)  # (batch, L, dg) of a mamba-130m scoring call
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
    "fwd_group": ("issue_copies", "scan", "wait_barrier", "writeout",
                  "convert", "barrier2"),
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


def bwd_edits(header: str):
    """The backward chunk loop's instrumentation: the same text in the
    bidir backward and in the grouped/folded body."""
    loop = "  for (int i = 0; i < nc; ++i) {\n"
    stage = ("    if (i + 1 < nc) stage(i + 1);  // in flight during this "
             "chunk\n")
    sync = ("    __syncthreads();  // both groups' outputs of this iteration "
            "are in smem\n")
    tail = ("    if (i + 1 < nc) {\n      cp_async_wait_all();\n"
            "      __syncthreads();  // every thread's copies of the next "
            "chunk landed\n      convert(i + 1);\n    }\n"
            "    __syncthreads();\n  }\n")
    return [
        header,
        (loop, "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n" + loop + tick(0)),
        (stage, stage + tick(1)),
        (sync, tick(2) + sync + tick(3)),
        (tail, tick(4) + tail.replace("    __syncthreads();\n  }\n", "")
         + tick(5) + "    __syncthreads();\n" + tick(6) + SAVE),
    ]


def bwd_source() -> str:
    src = (ROOT / "mamba_unet_torch/csrc/selective_scan_bidir_bwd.cu"
           ).read_text()
    return instrument(src, bwd_edits(("namespace {", HEADER)))


def group_sources(name: str) -> dict:
    """{file name: source} of the grouped or folded backward with its body
    instrumented."""
    csrc = ROOT / "mamba_unet_torch/csrc"
    body = "selective_scan_bwd_group.cuh"
    header = HEADER.replace("namespace {", "namespace scan_bwd {")
    return {f"{name}.cu": (csrc / f"{name}.cu").read_text(),
            body: instrument((csrc / body).read_text(),
                             bwd_edits(("namespace scan_bwd {", header)))}


def fwd_group_sources(name: str) -> dict:
    """{file name: source} of the grouped or folded forward with its body
    (csrc/selective_scan_fwd_group.cuh) instrumented."""
    csrc = ROOT / "mamba_unet_torch/csrc"
    body = "selective_scan_fwd_group.cuh"
    header = HEADER.replace("namespace {", "namespace scan_fwd {")
    loop = "  for (int i = 0; i < nch; ++i) {\n"
    stage = ("    if (i + 1 < nch) stage(i + 1);  // in flight during this "
             "chunk\n")
    wait = ("    cp_async_wait_all();\n    __syncthreads();  // y, the entry "
            "states and the next chunk's copies\n")
    tail = ("    if (i + 1 < nch) convert(i + 1);\n    __syncthreads();\n"
            "  }\n")
    return {f"{name}.cu": (csrc / f"{name}.cu").read_text(),
            body: instrument((csrc / body).read_text(), [
                ("namespace scan_fwd {", header),
                (loop, "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n" + loop
                 + tick(0)),
                (stage, stage + tick(1)),
                (wait, tick(2) + wait + tick(3)),
                (tail, tick(4) + "    if (i + 1 < nch) convert(i + 1);\n"
                 + tick(5) + "    __syncthreads();\n" + tick(6) + SAVE),
            ]),
            "selective_scan_bwd_group.cuh": (
                csrc / "selective_scan_bwd_group.cuh").read_text()}


def build(sources: dict, tmp: Path, name: str):
    """(entry point `name`, phase counter reader) of the library built from
    {file name: source}, whose first file is compiled."""
    from mamba_unet_torch.ops import _build

    d = tmp / name
    d.mkdir()
    for fname, src in sources.items():
        (d / fname).write_text(src)
    so = d / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(d / next(iter(sources)))], check=True)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    lib.phase_cycles.argtypes = [ctypes.c_void_p]
    lib.phase_cycles.restype = ctypes.c_int
    return fn, lib.phase_cycles


def launches(torch, dev, L, dg):
    """(tensors to keep alive, {label: (entry point, phase kind,
    call(fn) -> CUDA error, blocks)}) at (L, dg), bs24, fp32."""
    import chip_smoke
    from mamba_unet_torch.ops import selective_scan_bidir as ssb
    from mamba_unet_torch.ops import selective_scan_folded as ssf
    from mamba_unet_torch.ops import selective_scan_grouped as ssg

    f32 = dict(dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape):
        return torch.randn(*shape, generator=torch.Generator().manual_seed(1)
                           ).to(dev)

    def grads(du_shape, ddelta, ntile, dirs, lead):
        return [torch.empty(du_shape, **f32), torch.empty_like(ddelta),
                torch.empty(ntile, *lead, L, 16, **f32),
                torch.empty(ntile, *lead, L, 16, **f32),
                torch.empty(BATCH, dirs * dg, 16, **f32),
                torch.empty(BATCH, dirs * dg, **f32),
                torch.empty(BATCH, dirs * dg, **f32)]

    def ptrs(ts):
        return [t.data_ptr() for t in ts]

    # bidir: u2, delta4, A, B4, C4, D, delta_bias
    bi = chip_smoke.scan_inputs(torch, BATCH, L, dg, torch.float32, dev, 0)
    _, bi_cs = ssb.selective_scan_bidir_fwd_states(*bi)
    bi_gy = randn(BATCH, 2, L, dg)
    bi_out = torch.empty(bi[0].shape, **f32)
    nt = -(-dg // ssb.KERNEL_TILE)
    bi_grads = grads(bi[0].shape, bi[1], nt, 4, (BATCH, 4))
    bi_in = ptrs((bi[0], bi[1], bi[3], bi[4], bi[2], bi[5], bi[6]))
    # grouped, G = 4
    gr = chip_smoke.grouped_args(torch, BATCH, L, 4, dg, torch.float32, dev,
                                 0)
    _, gr_cs = ssg.selective_scan_grouped_fwd_states(*gr)
    gr_gy = randn(*gr[0].shape)
    gt = -(-dg // ssg.KERNEL_TILE)
    gr_grads = grads(gr[0].shape, gr[1], gt, 4, (BATCH, 4))
    gr_in = ptrs((gr[0], gr[1], gr[3], gr[4], gr[2], gr[5], gr[6]))
    # folded, bidirectional; B/C batch-major, as the wrapper passes them
    fo = chip_smoke.folded_args(torch, BATCH, L, dg, torch.float32, dev, 0)
    _, fo_cs = ssf.selective_scan_folded_fwd_states(*fo)
    fo_gy = randn(*fo[1].shape)
    ft = -(-dg // ssf.KERNEL_TILE[True])
    fo_grads = grads(fo[0].shape, fo[1], ft, 4, (4, BATCH))
    fo_bc = [t.permute(0, 3, 1, 2).contiguous() for t in (fo[3], fo[4])]
    fo_in = ptrs((fo[0], fo[1], *fo_bc, fo[2], fo[5], fo[6]))
    # the forwards' outputs: y and cs as the state-saving calls write them
    gr_y, fo_y = torch.empty_like(gr[0]), torch.empty_like(fo[1])
    gr_cs2, fo_cs2 = torch.empty_like(gr_cs), torch.empty_like(fo_cs)
    fb = -(-dg // (2 * 16))  # blocks per (direction, batch) of the forwards
    keep = (bi, bi_cs, bi_gy, bi_out, bi_grads, gr, gr_cs, gr_gy, gr_grads,
            fo, fo_cs, fo_gy, fo_grads, fo_bc, gr_y, fo_y, gr_cs2, fo_cs2)
    return keep, {
        "selective_scan_bidir_fwd": ("selective_scan_bidir_fwd", "fwd",
            lambda f: f(*bi_in, bi_out.data_ptr(), None, BATCH, L, dg, 16, 0,
                        stream), 2 * BATCH * nt),
        "selective_scan_bidir_bwd": ("selective_scan_bidir_bwd", "bwd",
            lambda f: f(*bi_in, bi_cs.data_ptr(), bi_gy.data_ptr(),
                        *ptrs(bi_grads), BATCH, L, dg, 16, 0, stream),
            2 * BATCH * nt),
        "selective_scan_fwd(states)": ("selective_scan_fwd", "fwd_group",
            lambda f: f(*gr_in, None, gr_y.data_ptr(), None,
                        gr_cs2.data_ptr(), BATCH, 4, L, dg, 16, 1, 0,
                        stream), 4 * BATCH * fb),
        "selective_scan_bwd": ("selective_scan_bwd", "bwd",
            lambda f: f(*gr_in, gr_cs.data_ptr(), gr_gy.data_ptr(),
                        *ptrs(gr_grads), None, None, BATCH, 4, L, dg, 16, 1,
                        0, stream),
            4 * BATCH * gt),
        "selective_scan_folded_fwd": ("selective_scan_folded_fwd",
            "fwd_group", lambda f: f(*fo_in, fo_y.data_ptr(), None, BATCH, 4,
                                     L, dg, 16, 1, 1, 0, stream),
            4 * BATCH * fb),
        "selective_scan_folded_fwd(states)": ("selective_scan_folded_fwd",
            "fwd_group", lambda f: f(*fo_in, fo_y.data_ptr(),
                                     fo_cs2.data_ptr(), BATCH, 4, L, dg, 16,
                                     1, 1, 0, stream), 4 * BATCH * fb),
        "selective_scan_folded_bwd": ("selective_scan_folded_bwd", "bwd",
            lambda f: f(*fo_in, fo_cs.data_ptr(), fo_gy.data_ptr(),
                        *ptrs(fo_grads), BATCH, 4, L, dg, 16, 1, 1, 0,
                        stream), 2 * BATCH * ft),
    }


def lm_launches(torch, dev):
    """(tensors to keep alive, {label: ...} as :func:`launches`) of the
    grouped serving forward at LM_SHAPE, fp32."""
    import chip_smoke

    bsz, L, dg = LM_SHAPE
    a = chip_smoke.grouped_args(torch, bsz, L, 1, dg, torch.float32, dev, 0)
    y = torch.empty_like(a[0])
    ins = [t.data_ptr() for t in (a[0], a[1], a[3], a[4], a[2], a[5], a[6])]
    stream = torch.cuda.current_stream().cuda_stream
    return (a, y), {"selective_scan_fwd(scoring)": (
        "selective_scan_fwd", "fwd_group",
        lambda f: f(*ins, None, y.data_ptr(), None, None, bsz, 1, L, dg, 16,
                    1, 0, stream), bsz * -(-dg // 32))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scan_phases: needs a CUDA card")
    import chip_smoke

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sources = {
            "selective_scan_bidir_fwd": {"fwd.cu": fwd_source()},
            "selective_scan_bidir_bwd": {"bwd.cu": bwd_source()},
            "selective_scan_bwd": group_sources("selective_scan_bwd"),
            "selective_scan_folded_bwd": group_sources(
                "selective_scan_folded_bwd"),
            "selective_scan_fwd": fwd_group_sources("selective_scan_fwd"),
            "selective_scan_folded_fwd": fwd_group_sources(
                "selective_scan_folded_fwd"),
        }
        kernels = {name: build(src, Path(tmp), name)
                   for name, src in sources.items()}
        cases = [(L, dg, lambda L=L, dg=dg: launches(torch, dev, L, dg))
                 for L, dg in SHAPES]
        cases.append((LM_SHAPE[1], LM_SHAPE[2],
                      lambda: lm_launches(torch, dev)))
        for L, dg, make in cases:
            keep, calls = make()
            for label, (name, kind, call, blocks) in calls.items():
                fn, read = kernels[name]
                ms, err = chip_smoke.cuda_ms(torch, lambda: call(fn), 5)
                if err:
                    raise SystemExit(f"{label} launch failed: {err}")
                buf = (ctypes.c_longlong * (MAX_BLOCKS * 8))()
                torch.cuda.synchronize()
                if read(buf):
                    raise SystemExit("reading the phase counters failed")
                cyc = torch.tensor(list(buf), dtype=torch.float64).reshape(
                    MAX_BLOCKS, 8)[:2 * blocks, :6].mean(0)
                total = cyc.sum().item()
                phases = PHASES[kind]
                bsz = LM_SHAPE[0] if label.endswith("(scoring)") else BATCH
                print(f"[phases] kernel={label} L={L} dg={dg} batch={bsz} "
                      f"ms={ms:.4f} cycles_per_group={total:.0f} " + " ".join(
                          f"{p}={100 * c / total:.1f}%" for p, c in
                          zip(phases, cyc.tolist())), flush=True)
            del keep
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
