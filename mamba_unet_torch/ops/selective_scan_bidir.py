"""Bidirectional selective scan for SS2D: CUDA kernel, plain version, wrapper.

The two data streams u2 = [row-major, column-major] are each scanned forward
and backward in time, giving the four SS2D directions [row, col, row-rev,
col-rev] (direction g reads stream g % 2; g >= 2 runs reversed). The output
is pair-summed in data order: out[:, m] = y_m + y_{m+2}. This is the contract
of ``mamba_unet_tpu``'s ``persistent_scan_bidir`` and
``selective_scan_pallas_bidir(merge_pairs=True)``, whose two TPU kernels the
one CUDA kernel ``csrc/selective_scan_bidir_fwd.cu`` replaces.

================  ================  =============
operand           shape             dtype
================  ================  =============
u2                (B, 2, L, dg)     fp32 or bf16
delta4            (B, 4, L, dg)     as u2
B4, C4            (B, 4, L, N)      as u2
A                 (4 * dg, N)       fp32
D, delta_bias     (4 * dg,)         fp32
out               (B, 2, L, dg)     fp32
================  ================  =============

``delta`` goes through softplus(delta + delta_bias); the state and all
arithmetic are fp32.
"""

from __future__ import annotations

import torch

from mamba_unet_torch.ops import _build
from mamba_unet_torch.ops.selective_scan import selective_scan_ref

KERNEL_N = 16  # the d_state the CUDA kernel is compiled for


def selective_scan_bidir_ref(u2, delta4, A, B4, C4, D, delta_bias):
    """Plain PyTorch version: flip the reversed directions explicitly and run
    :func:`selective_scan_ref` over all four at once (direction k is B/C
    group k). Returns the fp32 pair-summed (B, 2, L, dg)."""
    bsz, _, L, dg = delta4.shape
    u4 = torch.cat([u2, u2.flip(2)], dim=1)                # (B, 4, L, dg)
    d4 = torch.cat([delta4[:, :2], delta4[:, 2:].flip(2)], dim=1)
    b4 = torch.cat([B4[:, :2], B4[:, 2:].flip(2)], dim=1)
    c4 = torch.cat([C4[:, :2], C4[:, 2:].flip(2)], dim=1)
    y = selective_scan_ref(
        u4.float().transpose(2, 3).reshape(bsz, 4 * dg, L),
        d4.transpose(2, 3).reshape(bsz, 4 * dg, L),
        A, b4.transpose(2, 3), c4.transpose(2, 3),
        D=D, delta_bias=delta_bias, delta_softplus=True,
    ).reshape(bsz, 4, dg, L).transpose(2, 3)               # (B, 4, L, dg)
    return y[:, :2] + y[:, 2:].flip(2)


def _check(u2, delta4, A, B4, C4, D, delta_bias):
    if u2.dim() != 4 or u2.shape[1] != 2:
        raise ValueError(f"u2 must be (B, 2, L, dg), got {tuple(u2.shape)}")
    bsz, _, L, dg = u2.shape
    n = A.shape[-1]
    want = {
        "delta4": (delta4, (bsz, 4, L, dg)),
        "B4": (B4, (bsz, 4, L, n)),
        "C4": (C4, (bsz, 4, L, n)),
        "A": (A, (4 * dg, n)),
        "D": (D, (4 * dg,)),
        "delta_bias": (delta_bias, (4 * dg,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if u2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u2 must be float32 or bfloat16, got {u2.dtype}")
    for name, t in (("delta4", delta4), ("B4", B4), ("C4", C4)):
        if t.dtype != u2.dtype:
            raise TypeError(f"{name} is {t.dtype}, u2 is {u2.dtype}")
    for name, t in (("A", A), ("D", D), ("delta_bias", delta_bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def selective_scan_bidir(u2, delta4, A, B4, C4, D, delta_bias):
    """Pair-summed bidirectional scan -> fp32 (B, 2, L, dg).

    CPU tensors run :func:`selective_scan_bidir_ref`. CUDA tensors launch the
    CUDA kernel on the current stream, or raise: there is no fallback.
    Each kernel launch adds one to ``selective_scan_bidir.launches``.
    """
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    devices = {t.device for t in args}
    if devices == {torch.device("cpu")}:
        return selective_scan_bidir_ref(*args)
    if len(devices) != 1 or u2.device.type != "cuda":
        raise ValueError(f"all operands must be on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("selective_scan_bidir: CUDA operands must be "
                         "contiguous")
    n = A.shape[-1]
    if n != KERNEL_N:
        raise ValueError(f"the CUDA kernel is built for d_state={KERNEL_N}, "
                         f"got {n}")
    bsz, _, L, dg = u2.shape
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u2.device):
        out = torch.empty(u2.shape, dtype=torch.float32, device=u2.device)
        err = lib.selective_scan_bidir_fwd(
            u2.data_ptr(), delta4.data_ptr(), B4.data_ptr(), C4.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), out.data_ptr(),
            bsz, L, dg, n, int(u2.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bidir_fwd launch failed: CUDA "
                           f"error {err}")
    selective_scan_bidir.launches += 1
    return out


selective_scan_bidir.launches = 0
