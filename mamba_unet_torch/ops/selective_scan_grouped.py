"""Unidirectional grouped selective scan, time-major: CUDA kernel, plain
version, wrapper.

Port of ``mamba_unet_tpu/ops/selective_scan_pallas.py``'s
``selective_scan_pallas_tm`` (and, through the (B, D, L) dispatcher
``ops/selective_scan.py::selective_scan``, of ``selective_scan_pallas``).
The CUDA kernel ``csrc/selective_scan_fwd.cu`` replaces the TPU kernel
``_fwd_kernel`` in its unidirectional mode (``bidir=False``); it also
writes the final state, which the TPU wrapper could not
(``return_last_state`` went to the XLA scan there), so prefill runs the
kernel too.

================  ================  =============
operand           shape             dtype
================  ================  =============
u, delta          (B, G, L, dg)     fp32 or bf16
B, C              (B, G, L, N)      as u
A                 (G * dg, N)       fp32
D, delta_bias     (G * dg,)         fp32
y                 (B, G, L, dg)     as u
last state        (B, G * dg, N)    fp32
================  ================  =============

Channel block g of the G * dg channels reads B/C group g. ``delta`` goes
through delta + delta_bias, then softplus when ``softplus`` is set; the
state and all arithmetic are fp32, and y is rounded to the input dtype
once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mamba_unet_torch.ops import _build

KERNEL_N = 16  # the d_state the CUDA kernel is compiled for


def silu_gate(y, z, out_dtype):
    """``y * silu(z)`` in fp32, rounded to ``out_dtype``: the output gate
    that every caller of the scan applies after it (the kernel leaves it
    out, as the JAX package's Pallas wrapper applies it after its kernel)."""
    return (y.float() * F.silu(z.float())).to(out_dtype)


def selective_scan_grouped_ref(u, delta, A, B, C, D, delta_bias,
                               softplus=True, return_last_state=False):
    """Plain version: ``ops/selective_scan.py``'s sequential fp32 loop on
    the (B, D, L) view of the operands. Returns y in the dtype of ``u``,
    and with ``return_last_state`` also the fp32 (B, G * dg, N) state after
    step L."""
    # imported here: ops/selective_scan.py imports this module
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref

    bsz, G, L, dg = u.shape

    def channels_first(t):  # (B, G, L, w) -> (B, G * w, L)
        return t.transpose(2, 3).reshape(bsz, -1, L)

    out = selective_scan_ref(
        channels_first(u), channels_first(delta), A, B.transpose(2, 3),
        C.transpose(2, 3), D, None, delta_bias, softplus, return_last_state)
    y, last = out if return_last_state else (out, None)
    y = y.reshape(bsz, G, dg, L).transpose(2, 3)
    return (y, last) if return_last_state else y


def _check(u, delta, A, B, C, D, delta_bias):
    if u.dim() != 4:
        raise ValueError(f"u must be (B, G, L, dg), got {tuple(u.shape)}")
    bsz, G, L, dg = u.shape
    n = A.shape[-1]
    want = {
        "delta": (delta, (bsz, G, L, dg)),
        "B": (B, (bsz, G, L, n)),
        "C": (C, (bsz, G, L, n)),
        "A": (A, (G * dg, n)),
        "D": (D, (G * dg,)),
        "delta_bias": (delta_bias, (G * dg,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    for name, t in (("delta", delta), ("B", B), ("C", C)):
        if t.dtype != u.dtype:
            raise TypeError(f"{name} is {t.dtype}, u is {u.dtype}")
    for name, t in (("A", A), ("D", D), ("delta_bias", delta_bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _on_cuda(*tensors) -> bool:
    """False when every tensor lies on the CPU, True when all lie on one
    CUDA device, are contiguous and have the kernel's d_state; raise
    otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"all operands must be on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan_grouped: CUDA operands must be "
                         "contiguous")
    n = tensors[2].shape[-1]
    if n != KERNEL_N:
        raise ValueError(f"the CUDA kernel is built for d_state={KERNEL_N}, "
                         f"got {n}")
    return True


def selective_scan_grouped(u, delta, A, B, C, D, delta_bias, softplus=True,
                           return_last_state=False):
    """Time-major grouped scan -> y (B, G, L, dg) in the dtype of ``u``, or
    (y, fp32 last state (B, G * dg, N)) with ``return_last_state``.

    CPU tensors run :func:`selective_scan_grouped_ref`. CUDA tensors launch
    the kernel on the current stream, or raise: there is no fallback. Each
    launch adds one to ``selective_scan_grouped.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    if not _on_cuda(*args):
        return selective_scan_grouped_ref(*args, softplus, return_last_state)
    bsz, G, L, dg = u.shape
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u.device):
        y = torch.empty_like(u)
        last = (torch.empty(bsz, G * dg, KERNEL_N, dtype=torch.float32,
                            device=u.device) if return_last_state else None)
        err = lib.selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
            None if last is None else last.data_ptr(), bsz, G, L, dg,
            A.shape[-1], int(bool(softplus)), int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    selective_scan_grouped.launches += 1
    return (y, last) if return_last_state else y


selective_scan_grouped.launches = 0
