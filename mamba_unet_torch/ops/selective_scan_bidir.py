"""Bidirectional selective scan for SS2D: CUDA kernel, plain version, wrapper.

The two data streams u2 = [row-major, column-major] are each scanned forward
and backward in time, giving the four SS2D directions [row, col, row-rev,
col-rev] (direction g reads stream g % 2; g >= 2 runs reversed). The output
is pair-summed in data order: out[:, m] = y_m + y_{m+2}. This is the contract
of ``mamba_unet_tpu``'s ``persistent_scan_bidir`` and
``selective_scan_pallas_bidir(merge_pairs=True)``, whose two forward TPU
kernels the one CUDA kernel ``csrc/selective_scan_bidir_fwd.cu`` replaces;
``csrc/selective_scan_bidir_bwd.cu`` replaces the backward TPU kernel.

Three kernel entry points, each with its plain version and launch count:

* :func:`selective_scan_bidir` without grad - the serving forward (no saved
  states);
* :func:`selective_scan_bidir_fwd_states` - the forward that also writes the
  fp32 state entering every ``STATE_CHUNK``-step data chunk (``cs``), for
  training;
* :func:`selective_scan_bidir_bwd` - the backward from those states.

:func:`selective_scan_bidir` picks at call time: with grad enabled and an
operand that requires grad it runs the two training entry points through a
``torch.autograd.Function``, otherwise the serving kernel.

================  ================  =============
operand           shape             dtype
================  ================  =============
u2                (B, 2, L, dg)     fp32 or bf16
delta4            (B, 4, L, dg)     as u2
B4, C4            (B, 4, L, N)      as u2
A                 (4 * dg, N)       fp32
D, delta_bias     (4 * dg,)         fp32
out, gy           (B, 2, L, dg)     fp32
cs                (B, 4, nc, dg, N) fp32, nc = ceil(L / STATE_CHUNK)
================  ================  =============

``delta`` goes through softplus(delta + delta_bias); the state and all
arithmetic are fp32. The saved states are fixed in data time: ``cs[:, g,
k]`` is the state with which direction g enters the k-th STATE_CHUNK-step
chunk of data time that it scans (data chunk k for g < 2, data chunk
nc - 1 - k, entered at its last step, for g >= 2), as the TPU kernel's
``cs`` is.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mamba_unet_torch.ops import _build

KERNEL_N = 16  # the d_state the CUDA kernels are compiled for
STATE_CHUNK = 16  # data steps between saved states (kStateChunk in the .cu)
KERNEL_TILE = 16  # channels per block and direction of the backward (kCh)
ARG_NAMES = ("u2", "delta4", "A", "B4", "C4", "D", "delta_bias")


def selective_scan_bidir_states_ref(u2, delta4, A, B4, C4, D, delta_bias):
    """Plain version of the state-saving forward: the sequential fp32 loop
    over scan steps of all four directions at once (reversed directions
    flipped explicitly). Returns (fp32 pair-summed y, cs): cs[:, g, k] is the
    (dg, N) state with which direction g enters its k-th data chunk (module
    docstring): before scan step k * STATE_CHUNK for g < 2, before scan step
    max(0, L - (nc - k) * STATE_CHUNK) for g >= 2."""
    bsz, _, L, dg = delta4.shape
    u4 = torch.cat([u2, u2.flip(2)], dim=1).float()        # scan order
    d4 = torch.cat([delta4[:, :2], delta4[:, 2:].flip(2)], dim=1).float()
    b4 = torch.cat([B4[:, :2], B4[:, 2:].flip(2)], dim=1).float()
    c4 = torch.cat([C4[:, :2], C4[:, 2:].flip(2)], dim=1).float()
    dt = F.softplus(d4 + delta_bias.reshape(1, 4, 1, dg))  # (B, 4, L, dg)
    A4 = A.float().reshape(4, dg, -1)
    x = u4.new_zeros(bsz, 4, dg, A.shape[-1])
    ys, cs_fwd, cs_rev = [], [], []
    for t in range(L):
        if t % STATE_CHUNK == 0:
            cs_fwd.append(x[:, :2])
        if t == 0 or (L - t) % STATE_CHUNK == 0:
            cs_rev.append(x[:, 2:])
        d_t = dt[:, :, t, :, None]                             # (B,4,dg,1)
        x = torch.exp(d_t * A4) * x + (
            d_t * b4[:, :, t, None, :] * u4[:, :, t, :, None])
        ys.append(torch.einsum("bgdn,bgn->bgd", x, c4[:, :, t]))
    y = torch.stack(ys, dim=2) + u4 * D.reshape(1, 4, 1, dg)
    cs = torch.cat([torch.stack(cs_fwd, 2), torch.stack(cs_rev, 2)], 1)
    return y[:, :2] + y[:, 2:].flip(2), cs


def selective_scan_bidir_ref(u2, delta4, A, B4, C4, D, delta_bias):
    """Plain version of the forward: the fp32 pair-summed (B, 2, L, dg) of
    :func:`selective_scan_bidir_states_ref`."""
    return selective_scan_bidir_states_ref(u2, delta4, A, B4, C4, D,
                                           delta_bias)[0]


def _scan_order(x):
    """(B, 4, L, ...) in data order <-> scan order: directions 2 and 3
    reversed in time; its own inverse."""
    return torch.cat([x[:, :2], x[:, 2:].flip(2)], dim=1)


def selective_scan_bidir_bwd_ref(u2, delta4, A, B4, C4, D, delta_bias, gy):
    """Plain version of the backward, for the pair-summed cotangent ``gy``:
    the four directions in scan order through the grouped scan's plain
    backward (G = 4; a reverse-time loop, no autograd), the reversed
    directions' gradients flipped back and the two directions of each
    stream summed into du2. Returns the seven gradients, each in its
    operand's dtype."""
    # imported here: the grouped module imports this one
    from mamba_unet_torch.ops.selective_scan_grouped import (
        selective_scan_grouped_bwd_ref,
    )

    u4 = torch.cat([u2, u2], dim=1).float()
    gy4 = torch.cat([gy, gy], dim=1).float()
    du4, dd4, dA, dB4, dC4, dD, ddb = selective_scan_grouped_bwd_ref(
        _scan_order(u4), _scan_order(delta4.float()), A,
        _scan_order(B4.float()), _scan_order(C4.float()), D, delta_bias,
        _scan_order(gy4))
    du4 = _scan_order(du4)
    grads = (du4[:, :2] + du4[:, 2:], _scan_order(dd4), dA,
             _scan_order(dB4), _scan_order(dC4), dD, ddb)
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    return tuple(g.to(t.dtype).contiguous() for g, t in zip(grads, args))


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


def _on_cuda(*tensors) -> bool:
    """False when every tensor lies on the CPU, True when all lie on one
    CUDA device and are contiguous; raise otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"all operands must be on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selective_scan_bidir: CUDA operands must be "
                         "contiguous")
    n = tensors[2].shape[-1]
    if n != KERNEL_N:
        raise ValueError(f"the CUDA kernels are built for d_state={KERNEL_N}, "
                         f"got {n}")
    return True


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_fwd(args, cs):
    u2, delta4, A, B4, C4, D, delta_bias = args
    bsz, _, L, dg = u2.shape
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u2.device):
        out = torch.empty(u2.shape, dtype=torch.float32, device=u2.device)
        err = lib.selective_scan_bidir_fwd(
            u2.data_ptr(), delta4.data_ptr(), B4.data_ptr(), C4.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), out.data_ptr(),
            None if cs is None else cs.data_ptr(), bsz, L, dg, A.shape[-1],
            int(u2.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "selective_scan_bidir_fwd")
    return out


OCCUPANCY_KEYS = ("grid_x", "grid_y", "grid_z", "threads", "registers",
                  "static_smem", "dynamic_smem", "local_bytes",
                  "blocks_per_sm")


def kernel_occupancy(kind: str, bsz: int, L: int, dg: int,
                     bf16: bool = False) -> dict:
    """The launch configuration of the kernel that ``kind`` (``serve``,
    ``fwd_states`` or ``bwd``) launches at (bsz, L, dg), as the card
    reports it: OCCUPANCY_KEYS -> int (registers per thread, shared memory
    per block in bytes, local memory per thread in bytes, which counts
    spills, and the resident blocks per SM the occupancy calculator
    allows). Needs a card."""
    lib = _build.library()
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    if kind == "bwd":
        err = lib.selective_scan_bidir_bwd_occupancy(bsz, L, dg, int(bf16),
                                                     out)
    else:
        err = lib.selective_scan_bidir_fwd_occupancy(
            bsz, L, dg, int(bf16), int(kind == "fwd_states"), out)
    _raise_on(err, f"selective_scan_bidir {kind} occupancy")
    return dict(zip(OCCUPANCY_KEYS, out))


def _check_bwd(args, cs, gy):
    """The backward's operand checks: :func:`_check`, then ``cs`` and
    ``gy``."""
    _check(*args)
    u2 = args[0]
    bsz, _, L, dg = u2.shape
    want = (bsz, 4, -(-L // STATE_CHUNK), dg, args[2].shape[-1])
    if tuple(cs.shape) != want or cs.dtype != torch.float32:
        raise ValueError(f"cs must be float32 {want}, got {cs.dtype} "
                         f"{tuple(cs.shape)}")
    if tuple(gy.shape) != tuple(u2.shape) or gy.dtype != torch.float32:
        raise ValueError(f"gy must be float32 {tuple(u2.shape)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")


# The three kernel entry points as custom ops: a CPU implementation (the
# plain version), a CUDA one (the kernel, or raise) and a fake one (shapes
# and dtypes only, for torch.export). The checks run in all three.

@torch.library.custom_op("mamba_unet::selective_scan_bidir", mutates_args=(),
                         device_types="cpu")
def _serve_op(u2: torch.Tensor, delta4: torch.Tensor, A: torch.Tensor,
              B4: torch.Tensor, C4: torch.Tensor, D: torch.Tensor,
              delta_bias: torch.Tensor) -> torch.Tensor:
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    return selective_scan_bidir_ref(*args).contiguous()


@_serve_op.register_kernel("cuda")
def _serve_cuda(u2, delta4, A, B4, C4, D, delta_bias):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    out = _launch_fwd(args, None)
    selective_scan_bidir.launches += 1
    return out


@_serve_op.register_fake
def _serve_fake(u2, delta4, A, B4, C4, D, delta_bias):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    return torch.empty_like(u2, dtype=torch.float32)


@torch.library.custom_op("mamba_unet::selective_scan_bidir_fwd_states",
                         mutates_args=(), device_types="cpu")
def _fwd_states_op(u2: torch.Tensor, delta4: torch.Tensor, A: torch.Tensor,
                   B4: torch.Tensor, C4: torch.Tensor, D: torch.Tensor,
                   delta_bias: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    out, cs = selective_scan_bidir_states_ref(*args)
    return out.contiguous(), cs.contiguous()


@_fwd_states_op.register_kernel("cuda")
def _fwd_states_cuda(u2, delta4, A, B4, C4, D, delta_bias):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, _, L, dg = u2.shape
    cs = torch.empty(bsz, 4, -(-L // STATE_CHUNK), dg, KERNEL_N,
                     dtype=torch.float32, device=u2.device)
    out = _launch_fwd(args, cs)
    selective_scan_bidir_fwd_states.launches += 1
    return out, cs


@_fwd_states_op.register_fake
def _fwd_states_fake(u2, delta4, A, B4, C4, D, delta_bias):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, _, L, dg = u2.shape
    return torch.empty_like(u2, dtype=torch.float32), u2.new_empty(
        bsz, 4, -(-L // STATE_CHUNK), dg, A.shape[-1], dtype=torch.float32)


@torch.library.custom_op("mamba_unet::selective_scan_bidir_bwd",
                         mutates_args=(), device_types="cpu")
def _bwd_op(u2: torch.Tensor, delta4: torch.Tensor, A: torch.Tensor,
            B4: torch.Tensor, C4: torch.Tensor, D: torch.Tensor,
            delta_bias: torch.Tensor, cs: torch.Tensor, gy: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor]:
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check_bwd(args, cs, gy)
    return selective_scan_bidir_bwd_ref(*args, gy)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(u2, delta4, A, B4, C4, D, delta_bias, cs, gy):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check_bwd(args, cs, gy)
    _on_cuda(*args, cs, gy)
    bsz, _, L, dg = u2.shape
    n = A.shape[-1]
    ntile = -(-dg // KERNEL_TILE)
    lib = _build.library()
    with torch.cuda.device(u2.device):
        f32 = dict(dtype=torch.float32, device=u2.device)
        du2 = torch.empty(u2.shape, **f32)
        ddelta4 = torch.empty_like(delta4)
        dB_part = torch.empty(ntile, bsz, 4, L, n, **f32)
        dC_part = torch.empty(ntile, bsz, 4, L, n, **f32)
        dA_part = torch.empty(bsz, 4 * dg, n, **f32)
        dD_part = torch.empty(bsz, 4 * dg, **f32)
        ddb_part = torch.empty(bsz, 4 * dg, **f32)
        err = lib.selective_scan_bidir_bwd(
            u2.data_ptr(), delta4.data_ptr(), B4.data_ptr(), C4.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), cs.data_ptr(),
            gy.data_ptr(), du2.data_ptr(), ddelta4.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
            dD_part.data_ptr(), ddb_part.data_ptr(), bsz, L, dg, n,
            int(u2.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "selective_scan_bidir_bwd")
        selective_scan_bidir_bwd.launches += 1
        io = u2.dtype
        return (du2.to(io), ddelta4, dA_part.sum(0), dB_part.sum(0).to(io),
                dC_part.sum(0).to(io), dD_part.sum(0), ddb_part.sum(0))


@_bwd_op.register_fake
def _bwd_fake(u2, delta4, A, B4, C4, D, delta_bias, cs, gy):
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    _check_bwd(args, cs, gy)
    _on_cuda(*args, cs, gy)
    return tuple(torch.empty_like(t) for t in args)


def selective_scan_bidir_fwd_states(u2, delta4, A, B4, C4, D, delta_bias):
    """The training forward -> (fp32 pair-summed y, fp32 cs): the op
    ``mamba_unet::selective_scan_bidir_fwd_states``.

    CPU tensors run :func:`selective_scan_bidir_states_ref`; CUDA tensors
    launch the forward kernel with state saving on, or raise. Each launch
    adds one to ``selective_scan_bidir_fwd_states.launches``."""
    return _fwd_states_op(u2, delta4, A, B4, C4, D, delta_bias)


def selective_scan_bidir_bwd(u2, delta4, A, B4, C4, D, delta_bias, cs, gy):
    """The backward -> (du2, ddelta4, dA, dB4, dC4, dD, ddelta_bias), each
    in its operand's dtype (du2, ddelta4, dB4, dC4 in the I/O dtype; the
    kernel accumulates in fp32): the op
    ``mamba_unet::selective_scan_bidir_bwd``.

    ``cs`` is the state-saving forward's second output and ``gy`` the fp32
    cotangent of its pair-summed output. CPU tensors run
    :func:`selective_scan_bidir_bwd_ref` (which recomputes instead of reading
    ``cs``); CUDA tensors launch the backward kernel and reduce its fp32
    partial sums (over channel tiles for dB/dC, over the batch for
    dA/dD/ddelta_bias: a fixed order, so the result is deterministic), or
    raise. Each launch adds one to ``selective_scan_bidir_bwd.launches``."""
    return _bwd_op(u2, delta4, A, B4, C4, D, delta_bias, cs, gy)


class _ScanBidir(torch.autograd.Function):
    """The training scan: the state-saving forward, and the backward kernel
    on the pair-summed fp32 cotangent."""

    @staticmethod
    def forward(ctx, u2, delta4, A, B4, C4, D, delta_bias):
        out, cs = selective_scan_bidir_fwd_states(u2, delta4, A, B4, C4, D,
                                                  delta_bias)
        ctx.save_for_backward(u2, delta4, A, B4, C4, D, delta_bias, cs)
        return out

    @staticmethod
    def backward(ctx, gy):
        return selective_scan_bidir_bwd(*ctx.saved_tensors,
                                        gy.float().contiguous())


def selective_scan_bidir(u2, delta4, A, B4, C4, D, delta_bias):
    """Pair-summed bidirectional scan -> fp32 (B, 2, L, dg).

    With grad enabled and an operand that requires grad, this is the
    differentiable training scan: the state-saving forward and the backward
    (kernels on CUDA tensors, their plain versions on CPU tensors).
    Otherwise it is the serving forward, the op
    ``mamba_unet::selective_scan_bidir``: CPU tensors run
    :func:`selective_scan_bidir_ref`, CUDA tensors launch the forward kernel
    without saved states on the current stream, or raise: there is no
    fallback. Each serving launch adds one to
    ``selective_scan_bidir.launches``."""
    args = (u2, delta4, A, B4, C4, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ScanBidir.apply(*args)
    return _serve_op(*args)


selective_scan_bidir.launches = 0
selective_scan_bidir_fwd_states.launches = 0
selective_scan_bidir_bwd.launches = 0
