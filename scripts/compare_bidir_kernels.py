#!/usr/bin/env python3
"""Time two versions of the bidirectional scan kernels on one card, in turns.

    python3 scripts/compare_bidir_kernels.py OLD_DIR [NEW_DIR]

OLD_DIR and NEW_DIR each hold a ``selective_scan_bidir_fwd.cu`` and a
``selective_scan_bidir_bwd.cu`` with this repository's C interface
(NEW_DIR defaults to ``mamba_unet_torch/csrc``); for another commit's
kernels, unpack them with ``git show <rev>:<path>`` into a directory that
``.gitignore`` lists. Each version is built with its own ``nvcc``, and at
the four stage shapes of the 224² model (bs24, fp32 and bf16 inputs) the
serving forward, the state-saving forward and the backward of each are
timed in the order old, new, new, old, each output held against the plain
PyTorch versions (``utils/compare.py``'s rule). Prints per stage the two
times of each, and per forward or train step (14 calls, fp32) the mean.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
BATCH = 24
KINDS = (("serve", "fwd"), ("fwd_states", "fwd"), ("bwd", "bwd"))


def build(src_dir: Path, tmp: Path, tag: str) -> dict:
    """{"fwd": fn, "bwd": fn} of the sources in src_dir."""
    from mamba_unet_torch.ops import _build

    procs = {}
    for kind in ("fwd", "bwd"):
        so = tmp / f"lib{tag}_{kind}.so"
        procs[kind] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
             str(src_dir / f"selective_scan_bidir_{kind}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for kind, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag} {kind}:\n{out}")
        fn = getattr(ctypes.CDLL(str(so)), f"selective_scan_bidir_{kind}")
        fn.argtypes = _build._SIGNATURES[f"selective_scan_bidir_{kind}"]
        fn.restype = ctypes.c_int
        fns[kind] = fn
    return fns


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("compare_bidir_kernels: needs a CUDA card")
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    import chip_smoke
    from mamba_unet_torch.ops import selective_scan_bidir as ssb
    from mamba_unet_torch.utils.compare import assert_close_to_max

    dirs = {"old": Path(argv[0]),
            "new": Path(argv[1]) if len(argv) > 1
            else ROOT / "mamba_unet_torch" / "csrc"}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    per_step = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {tag: build(d, Path(tmp), tag) for tag, d in dirs.items()}
        for L, dg, calls in chip_smoke.STAGES:
            for dtype in (torch.float32, torch.bfloat16):
                args = chip_smoke.scan_inputs(torch, BATCH, L, dg, dtype,
                                              dev, 0)
                gy = torch.randn(BATCH, 2, L, dg, generator=torch.Generator()
                                 .manual_seed(1)).to(dev)
                y_ref, cs_ref = ssb.selective_scan_bidir_states_ref(*args)
                g_ref = ssb.selective_scan_bidir_bwd_ref(*args, gy)
                f32 = dict(dtype=torch.float32, device=dev)
                out = torch.empty(y_ref.shape, **f32)
                cs = torch.empty(cs_ref.shape, **f32)
                ntile = -(-dg // ssb.KERNEL_TILE)
                parts = [torch.empty(args[0].shape, **f32),
                         torch.empty_like(args[1]),
                         torch.empty(ntile, BATCH, 4, L, 16, **f32),
                         torch.empty(ntile, BATCH, 4, L, 16, **f32),
                         torch.empty(BATCH, 4 * dg, 16, **f32),
                         torch.empty(BATCH, 4 * dg, **f32),
                         torch.empty(BATCH, 4 * dg, **f32)]
                u2, d4, A, B4, C4, D, db = args
                ptrs = [t.data_ptr() for t in (u2, d4, B4, C4, A, D, db)]
                bf16 = int(dtype == torch.bfloat16)
                stream = torch.cuda.current_stream().cuda_stream
                times = {}
                for tag in ("old", "new", "new", "old"):
                    fwd, bwd = libs[tag]["fwd"], libs[tag]["bwd"]
                    launches = {
                        "serve": lambda: fwd(*ptrs, out.data_ptr(), None,
                                             BATCH, L, dg, 16, bf16, stream),
                        "fwd_states": lambda: fwd(
                            *ptrs, out.data_ptr(), cs.data_ptr(), BATCH, L,
                            dg, 16, bf16, stream),
                        "bwd": lambda: bwd(
                            *ptrs, cs.data_ptr(), gy.data_ptr(),
                            *[t.data_ptr() for t in parts], BATCH, L, dg,
                            16, bf16, stream),
                    }
                    for kind, _ in KINDS:
                        ms, err = chip_smoke.cuda_ms(torch, launches[kind],
                                                     20)
                        if err:
                            raise SystemExit(f"{tag} {kind} failed: {err}")
                        times.setdefault(f"{tag}_{kind}", []).append(ms)
                        if dtype == torch.float32:
                            key = f"{tag}_{kind}"
                            per_step[key] = per_step.get(key, 0.0) + (
                                calls * ms / 2)
                    where = f"{tag} L={L} dg={dg} {dtype}"
                    assert_close_to_max(out, y_ref, 1e-4, f"y, {where}")
                    assert_close_to_max(cs, cs_ref, 1e-4, f"cs, {where}")
                    io = u2.dtype
                    got = (parts[0].to(io), parts[1], parts[4].sum(0),
                           parts[2].sum(0).to(io), parts[3].sum(0).to(io),
                           parts[5].sum(0), parts[6].sum(0))
                    for name, g, w in zip(ssb.ARG_NAMES, got, g_ref):
                        summed = name in ("A", "D", "delta_bias")
                        assert_close_to_max(g, w, 1e-3 if summed else 1e-4,
                                            f"d{name}, {where}")
                print(f"[compare] L={L} dg={dg} batch={BATCH} "
                      f"dtype={str(dtype).split('.')[-1]} " + " ".join(
                          f"{k}_ms={'/'.join(f'{v:.4f}' for v in vs)}"
                          for k, vs in times.items()), flush=True)
                del args, gy, y_ref, cs_ref, g_ref, out, cs, parts
                torch.cuda.empty_cache()
    print("[compare] fp32 per forward (serve) or train step, 14 calls: "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in per_step.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
