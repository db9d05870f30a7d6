#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device   - require CUDA; print ``nvidia-smi`` name and power limit.
2. build    - compile the CUDA kernels from ``mamba_unet_torch/csrc``.
3. kernel   - ``selective_scan_bidir`` (CUDA) against its plain PyTorch
              version at the four stage shapes of the 224² model, batch 2,
              fp32 and bf16 inputs; then both timed at batch 24, where the
              timed calls' outputs are compared again.
4. parity   - full-width Mamba-UNet (vmamba-tiny, seeded weights), batch 2
              at 224²: logits on the card (kernel) against a CPU copy (plain
              scan), fp32 with TF32 off; then bf16 serving against fp32.
5. serving  - 3 synthetic phantom volumes (10 slices, native 256x216)
              through ``cli.test.infer_volume`` at batch 24, fp32 and bf16,
              with PyTorch's TF32 defaults restored; the kernel must launch
              14 times per served forward.

Then one JSON line with the kernel table, and the last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SS2D_PER_FORWARD = 14  # 8 encoder + 6 decoder blocks
# (L, dg) of SS2D's scan per stage at 224², and its calls per forward
STAGES = ((3136, 192, 4), (784, 384, 4), (196, 768, 4), (49, 1536, 2))
# kernel vs plain: both read the same values (bf16 is widened exactly), so
# only the fp32 summation order differs; 1e-4 bounds that over L=3136
KERNEL_TOL = 1e-4
# full model, card vs CPU, fp32 with TF32 off: 14 scans plus the stock
# layers in another summation order
LOGIT_TOL = 1e-3
MIN_ARGMAX_AGREEMENT = 0.999
# bf16 serving against fp32 on the card: bf16 rounds every matmul/conv input
# (8-bit mantissa) through 14 blocks, and random-weight logits have near
# ties; about 4x the max abs difference and 3x the disagreement measured on
# an H100 (0.06 of logits up to 4.6; 99.4 % argmax agreement)
BF16_LOGIT_TOL = 0.25
BF16_MIN_ARGMAX_AGREEMENT = 0.98


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def scan_inputs(torch, bsz, L, dg, dtype, device, seed):
    """Scan operands at the magnitudes of the initialized model: A from the
    S4D init, delta_bias from the dt init, D = 1."""
    from mamba_unet_torch.nn.ss2d import a_log_init, dt_bias_init

    g = torch.Generator().manual_seed(seed)
    n = 16
    args = [torch.randn(bsz, 2, L, dg, generator=g),
            0.5 * torch.randn(bsz, 4, L, dg, generator=g),
            -torch.exp(a_log_init(4 * dg, n)),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.randn(bsz, 4, L, n, generator=g),
            torch.ones(4 * dg),
            dt_bias_init((4 * dg,), g)]
    args = [a.to(device) for a in args]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    return args


def cuda_ms(torch, fn, iters):
    """(mean ms per call over ``iters`` calls after one warm-up call, the
    last call's output)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def check_kernel(torch, got, want, **where) -> float:
    """Raise unless the kernel's output matches the plain version's within
    KERNEL_TOL; return the max abs error."""
    err = (got - want).abs().max().item()
    ok = (torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
          and bool(torch.isfinite(got).all()))
    log("kernel", **where, max_abs_err=f"{err:.3e}",
        ref_max=f"{want.abs().max():.3f}", tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"kernel disagrees at {where}: max abs err {err}")
    return err


def main() -> int:
    import torch

    # --- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from mamba_unet_torch.cli.test import BATCH_SIZE as SERVE_BATCH
    from mamba_unet_torch.cli.test import infer_volume
    from mamba_unet_torch.ops import _build
    from mamba_unet_torch.ops.selective_scan_bidir import (
        selective_scan_bidir,
        selective_scan_bidir_ref,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log("device", name=repr(name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # --- 2. build
    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        lib=_build.build().name)

    # --- 3. kernel vs plain at batch 2, then timed and compared at batch 24
    max_err = 0.0
    ms_fwd = plain_ms_fwd = 0.0
    for L, dg, calls in STAGES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(torch, 2, L, dg, dtype, dev, seed=L)
            err = check_kernel(torch, selective_scan_bidir(*args),
                               selective_scan_bidir_ref(*args), L=L, dg=dg,
                               batch=2, dtype=str(dtype).split(".")[-1])
            max_err = max(max_err, err)
        times = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            args = scan_inputs(torch, SERVE_BATCH, L, dg, dtype, dev, 0)
            ms, got = cuda_ms(torch, lambda: selective_scan_bidir(*args), 20)
            plain, want = cuda_ms(
                torch, lambda: selective_scan_bidir_ref(*args), 1)
            err = check_kernel(torch, got, want, L=L, dg=dg,
                               batch=SERVE_BATCH, dtype=tag)
            max_err = max(max_err, err)
            times[tag] = (ms, plain)
            del args, got, want
        ms, plain = times["float32"]
        ms_fwd += calls * ms
        plain_ms_fwd += calls * plain
        log("kernel_time", L=L, dg=dg, batch=SERVE_BATCH, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.2f}", speedup=f"{plain / ms:.1f}x",
            bf16_ms=f"{times['bfloat16'][0]:.4f}",
            bf16_plain_ms=f"{times['bfloat16'][1]:.2f}")
    log("kernel_time", per_forward_ms=f"{ms_fwd:.4f}",
        plain_per_forward_ms=f"{plain_ms_fwd:.2f}", calls=SS2D_PER_FORWARD)

    # --- 4. full-width model: card (kernel) vs CPU copy (plain scan)
    from mamba_unet_torch.data.synthetic import phantom_volumes
    from mamba_unet_torch.models.vssm import MambaUnet
    from mamba_unet_torch.utils.checkpoint import load_model_snapshot
    from mamba_unet_torch.utils.export import make_predict_fn

    model = load_model_snapshot("ViM_seg", 4, 1, device=dev)
    cpu_model = MambaUnet(num_classes=4).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    x = torch.randn(2, 224, 224, 1, generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    got = make_predict_fn(model)(x.to(dev)).cpu()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = make_predict_fn(cpu_model)(x)
    cpu_s = time.perf_counter() - t0
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log("parity", shape=tuple(got.shape), max_abs_err=f"{err:.3e}",
        logit_max=f"{want.abs().max():.3f}", argmax_agree=f"{agree:.6f}",
        tol=LOGIT_TOL, gpu_s=f"{gpu_s:.2f}", cpu_s=f"{cpu_s:.2f}")
    if got.shape != (2, 224, 224, 4) or not torch.isfinite(got).all():
        raise AssertionError(f"bad logits: {tuple(got.shape)}")
    if err > LOGIT_TOL or agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"card logits disagree with the CPU: max abs "
                             f"err {err}, argmax agreement {agree}")
    del cpu_model
    bf16 = make_predict_fn(model, torch.bfloat16)(x.to(dev)).cpu()
    err16 = (bf16 - got).abs().max().item()
    agree16 = (bf16.argmax(-1) == got.argmax(-1)).float().mean().item()
    log("parity", compare="bf16_vs_fp32_card", max_abs_diff=f"{err16:.3e}",
        argmax_agree=f"{agree16:.6f}", tol=BF16_LOGIT_TOL)
    if (not torch.isfinite(bf16).all() or err16 > BF16_LOGIT_TOL
            or agree16 < BF16_MIN_ARGMAX_AGREEMENT):
        raise AssertionError(f"bf16 logits stray from fp32: max abs diff "
                             f"{err16}, argmax agreement {agree16}")

    # --- 5. serving through the test CLI's per-volume function, with the
    # TF32 settings a user of make_predict_fn gets
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32_defaults
    log("serving", matmul_tf32=tf32_defaults[0], cudnn_tf32=tf32_defaults[1])
    vols = phantom_volumes(3, 10, 256, 216, seed=0)
    forwards = sum(math.ceil(len(v["image"]) / SERVE_BATCH) for v in vols)
    fns = {"fp32": make_predict_fn(model),
           "bf16": make_predict_fn(model, torch.bfloat16)}
    warm = torch.zeros(SERVE_BATCH, 224, 224, 1, device=dev)
    for fn in fns.values():  # first-call set-up (cuDNN, autocast caches)
        fn(warm)
    torch.cuda.synchronize()

    selective_scan_bidir.launches = 0
    served = {}
    for tag, fn in fns.items():
        lat = []
        for v in vols:
            t0 = time.perf_counter()
            _, metrics = infer_volume(v["image"], v["label"], fn, 4,
                                      (224, 224))
            lat.append(time.perf_counter() - t0)
            if not all(math.isfinite(m) for row in metrics for m in row):
                raise AssertionError(f"non-finite metrics {metrics}")
        served[tag] = lat
    launches = selective_scan_bidir.launches
    expect = SS2D_PER_FORWARD * forwards * len(fns)
    log("serving", volumes=len(vols), slices_per_volume=10,
        native="256x216", forwards=forwards * len(fns), launches=launches,
        expected=expect)
    if launches != expect:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{expect} ({SS2D_PER_FORWARD} per forward)")

    for tag, fn in fns.items():
        batch = torch.randn(SERVE_BATCH, 224, 224, 1, device=dev)
        ms, _ = cuda_ms(torch, lambda: fn(batch), 10)
        lat = served[tag]
        log("serving", dtype=tag, batch=SERVE_BATCH, forward_ms=f"{ms:.2f}",
            slices_per_s=f"{SERVE_BATCH / ms * 1e3:.1f}",
            volume_latency_ms=f"{1e3 * sum(lat) / len(lat):.1f}",
            volume_slices_per_s=f"{10 * len(lat) / sum(lat):.1f}")

    print(json.dumps({"kernels": [{
        "name": "selective_scan_bidir_fwd",
        "route": "cuda",
        "source": "mamba_unet_torch/csrc/selective_scan_bidir_fwd.cu",
        "replaces": ("mamba_unet_tpu/ops/selective_scan_persistent.py:130, "
                     "mamba_unet_tpu/ops/selective_scan_pallas.py:229"),
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_fwd,
        "plain_ms": plain_ms_fwd,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
