"""Unidirectional grouped selective scan, time-major: CUDA kernels, plain
versions, wrapper.

Port of ``mamba_unet_tpu/ops/selective_scan_pallas.py``'s
``selective_scan_pallas_tm`` (and, through the (B, D, L) dispatcher
``ops/selective_scan.py::selective_scan``, of ``selective_scan_pallas``),
forward and VJP. The CUDA kernel ``csrc/selective_scan_fwd.cu`` replaces the
TPU kernel ``_fwd_kernel`` in its unidirectional mode (``bidir=False``); it
also writes the final state, which the TPU wrapper could not
(``return_last_state`` went to the XLA scan there), so prefill runs the
kernel too. Its state-saving variant and ``csrc/selective_scan_bwd.cu``
replace the same call with ``save_cs=True`` and the unidirectional
``_bwd_kernel``.

Three kernel entry points, each with its plain version and launch count:

* :func:`selective_scan_grouped` without grad - the serving forward;
* :func:`selective_scan_grouped_fwd_states` - the forward that also writes
  the fp32 state at every ``STATE_CHUNK``-th step (``cs``), for training;
* :func:`selective_scan_grouped_bwd` - the backward from those states.

:func:`selective_scan_grouped` picks at call time: with grad enabled and an
operand that requires grad it runs the two training entry points through a
``torch.autograd.Function``, otherwise the serving kernel.

================  ==================  =============
operand           shape               dtype
================  ==================  =============
u, delta          (B, G, L, dg)       fp32 or bf16
B, C              (B, G, L, N)        as u
A                 (G * dg, N)         fp32
D, delta_bias     (G * dg,)           fp32
y, gy             (B, G, L, dg)       as u
last state        (B, G * dg, N)      fp32
cs                (B, G, nc, N, dg)   fp32, nc = ceil(L / STATE_CHUNK)
================  ==================  =============

Channel block g of the G * dg channels reads B/C group g. ``delta`` goes
through delta + delta_bias, then softplus when ``softplus`` is set; the
state and all arithmetic are fp32, and y is rounded to the input dtype
once. The cotangent ``gy`` is taken in the I/O dtype, as the TPU backward
reads it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mamba_unet_torch.ops import _build
from mamba_unet_torch.ops.selective_scan_bidir import OCCUPANCY_KEYS

KERNEL_N = 16  # the d_state the CUDA kernels are compiled for
STATE_CHUNK = 16  # steps between saved states (kStateChunk in the .cuh)
KERNEL_TILE = 32  # channels per block of the backward (2 * kCh)
ARG_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def silu_gate(y, z, out_dtype):
    """``y * silu(z)`` in fp32, rounded to ``out_dtype``: the output gate
    that every caller of the scan applies after it (the kernel leaves it
    out, as the JAX package's Pallas wrapper applies it after its kernel)."""
    return (y.float() * F.silu(z.float())).to(out_dtype)


def _channels_first(t):
    """(B, G, L, w) -> (B, G * w, L)."""
    return t.transpose(2, 3).reshape(t.shape[0], -1, t.shape[2])


def _plain(u, delta, A, B, C, D, delta_bias, softplus, return_last_state,
           state_chunk=0):
    """``ops/selective_scan.py``'s sequential fp32 loop on the (B, D, L)
    view of the time-major operands; y back in (B, G, L, dg)."""
    # imported here: ops/selective_scan.py imports this module
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref

    bsz, G, L, dg = u.shape
    out = selective_scan_ref(
        _channels_first(u), _channels_first(delta), A, B.transpose(2, 3),
        C.transpose(2, 3), D, None, delta_bias, softplus, return_last_state,
        state_chunk=state_chunk)
    y, *extra = out if isinstance(out, tuple) else (out,)
    return (y.reshape(bsz, G, dg, L).transpose(2, 3), *extra)


def selective_scan_grouped_ref(u, delta, A, B, C, D, delta_bias,
                               softplus=True, return_last_state=False):
    """Plain version of the forward: y in the dtype of ``u``, and with
    ``return_last_state`` also the fp32 (B, G * dg, N) state after step L."""
    out = _plain(u, delta, A, B, C, D, delta_bias, softplus,
                 return_last_state)
    return out if return_last_state else out[0]


def selective_scan_grouped_states_ref(u, delta, A, B, C, D, delta_bias,
                                      softplus=True):
    """Plain version of the state-saving forward -> (y in the dtype of
    ``u``, cs): cs[:, g, c] is the fp32 (N, dg) state of group g entering
    step c * STATE_CHUNK."""
    bsz, G, L, dg = u.shape
    y, states = _plain(u, delta, A, B, C, D, delta_bias, softplus, False,
                       STATE_CHUNK)                     # (B, nc, G*dg, N)
    cs = states.reshape(bsz, -1, G, dg, A.shape[-1]).permute(0, 2, 1, 4, 3)
    return y, cs.contiguous()


def selective_scan_grouped_bwd_ref(u, delta, A, B, C, D, delta_bias, gy,
                                   softplus=True):
    """Plain version of the backward: ``ops/selective_scan.py``'s
    reverse-time loop (``selective_scan_ref_bwd``, no autograd) on the
    (B, D, L) view, for the cotangent ``gy``. Returns the seven gradients,
    each in its operand's dtype."""
    # imported here: ops/selective_scan.py imports this module
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref_bwd

    bsz, G, L, dg = u.shape
    du, ddelta, dA, dB, dC, dD, ddb = selective_scan_ref_bwd(
        _channels_first(u), _channels_first(delta), A, B.transpose(2, 3),
        C.transpose(2, 3), D, delta_bias, softplus, _channels_first(gy))

    def time_major(t):  # (B, G * dg, L) -> (B, G, L, dg)
        return t.reshape(bsz, G, dg, L).transpose(2, 3)

    grads = (time_major(du), time_major(ddelta), dA, dB.transpose(2, 3),
             dC.transpose(2, 3), dD, ddb)
    args = (u, delta, A, B, C, D, delta_bias)
    return tuple(g.to(t.dtype).contiguous() for g, t in zip(grads, args))


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
        raise ValueError(f"the CUDA kernels are built for d_state={KERNEL_N}, "
                         f"got {n}")
    return True


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _launch_fwd(args, softplus, last, cs):
    """Launch the forward kernel -> y; ``last`` and ``cs`` are its optional
    fp32 outputs (None: not written)."""
    u, delta, A, B, C, D, delta_bias = args
    bsz, G, L, dg = u.shape
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u.device):
        y = torch.empty_like(u)
        err = lib.selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
            None if last is None else last.data_ptr(),
            None if cs is None else cs.data_ptr(), bsz, G, L, dg,
            A.shape[-1], int(bool(softplus)), int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "selective_scan_fwd")
    return y


def kernel_occupancy(kind: str, bsz: int, G: int, L: int, dg: int,
                     bf16: bool = False) -> dict:
    """The launch configuration of the kernel that ``kind`` (``serve``,
    ``fwd_states`` or ``bwd``) launches at (bsz, G, L, dg), as the card
    reports it: ``selective_scan_bidir.OCCUPANCY_KEYS`` -> int. Needs a
    card."""
    lib = _build.library()
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    if kind == "bwd":
        err = lib.selective_scan_bwd_occupancy(bsz, G, L, dg, int(bf16), out)
    else:
        err = lib.selective_scan_fwd_occupancy(
            bsz, G, L, dg, int(bf16), int(kind == "fwd_states"), out)
    _raise_on(err, f"selective_scan_grouped {kind} occupancy")
    return dict(zip(OCCUPANCY_KEYS, out))


def _check_bwd(args, cs, gy):
    """The backward's operand checks: :func:`_check`, then ``cs`` and
    ``gy``."""
    _check(*args)
    u = args[0]
    bsz, G, L, dg = u.shape
    want = (bsz, G, -(-L // STATE_CHUNK), args[2].shape[-1], dg)
    if tuple(cs.shape) != want or cs.dtype != torch.float32:
        raise ValueError(f"cs must be float32 {want}, got {cs.dtype} "
                         f"{tuple(cs.shape)}")
    if tuple(gy.shape) != tuple(u.shape) or gy.dtype != u.dtype:
        raise ValueError(f"gy must be {u.dtype} {tuple(u.shape)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")


def _no_last_state(u):
    """The serving op's second output when no final state is asked for."""
    return u.new_empty(0, dtype=torch.float32)


# The three kernel entry points as custom ops: a CPU implementation (the
# plain version), a CUDA one (the kernel, or raise) and a fake one (shapes
# and dtypes only, for torch.export). The checks run in all three.

@torch.library.custom_op("mamba_unet::selective_scan_grouped",
                         mutates_args=(), device_types="cpu")
def _serve_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              delta_bias: torch.Tensor, softplus: bool,
              return_last_state: bool) -> tuple[torch.Tensor, torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    y, *last = _plain(*args, softplus, return_last_state)
    return y.contiguous(), last[0] if last else _no_last_state(u)


@_serve_op.register_kernel("cuda")
def _serve_cuda(u, delta, A, B, C, D, delta_bias, softplus,
                return_last_state):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, G, L, dg = u.shape
    last = (torch.empty(bsz, G * dg, KERNEL_N, dtype=torch.float32,
                        device=u.device) if return_last_state else None)
    y = _launch_fwd(args, softplus, last, None)
    selective_scan_grouped.launches += 1
    return y, _no_last_state(u) if last is None else last


@_serve_op.register_fake
def _serve_fake(u, delta, A, B, C, D, delta_bias, softplus,
                return_last_state):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, G, L, dg = u.shape
    last = (u.new_empty(bsz, G * dg, A.shape[-1], dtype=torch.float32)
            if return_last_state else _no_last_state(u))
    return torch.empty_like(u), last


@torch.library.custom_op("mamba_unet::selective_scan_grouped_fwd_states",
                         mutates_args=(), device_types="cpu")
def _fwd_states_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   delta_bias: torch.Tensor, softplus: bool
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    y, cs = selective_scan_grouped_states_ref(*args, softplus)
    return y.contiguous(), cs


@_fwd_states_op.register_kernel("cuda")
def _fwd_states_cuda(u, delta, A, B, C, D, delta_bias, softplus):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, G, L, dg = u.shape
    cs = torch.empty(bsz, G, -(-L // STATE_CHUNK), KERNEL_N, dg,
                     dtype=torch.float32, device=u.device)
    y = _launch_fwd(args, softplus, None, cs)
    selective_scan_grouped_fwd_states.launches += 1
    return y, cs


@_fwd_states_op.register_fake
def _fwd_states_fake(u, delta, A, B, C, D, delta_bias, softplus):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _on_cuda(*args)
    bsz, G, L, dg = u.shape
    return torch.empty_like(u), u.new_empty(
        bsz, G, -(-L // STATE_CHUNK), A.shape[-1], dg, dtype=torch.float32)


@torch.library.custom_op("mamba_unet::selective_scan_grouped_bwd",
                         mutates_args=(), device_types="cpu")
def _bwd_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            delta_bias: torch.Tensor, cs: torch.Tensor, gy: torch.Tensor,
            softplus: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy)
    return selective_scan_grouped_bwd_ref(*args, gy, softplus)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(u, delta, A, B, C, D, delta_bias, cs, gy, softplus):
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy)
    _on_cuda(*args, cs, gy)
    bsz, G, L, dg = u.shape
    n = A.shape[-1]
    ntile = -(-dg // KERNEL_TILE)
    lib = _build.library()
    with torch.cuda.device(u.device):
        f32 = dict(dtype=torch.float32, device=u.device)
        du = torch.empty_like(u)
        ddelta = torch.empty_like(delta)
        dB_part = torch.empty(ntile, bsz, G, L, n, **f32)
        dC_part = torch.empty(ntile, bsz, G, L, n, **f32)
        dA_part = torch.empty(bsz, G * dg, n, **f32)
        dD_part = torch.empty(bsz, G * dg, **f32)
        ddb_part = torch.empty(bsz, G * dg, **f32)
        err = lib.selective_scan_bwd(
            u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), cs.data_ptr(),
            gy.data_ptr(), du.data_ptr(), ddelta.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
            dD_part.data_ptr(), ddb_part.data_ptr(), bsz, G, L, dg, n,
            int(bool(softplus)), int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "selective_scan_bwd")
        selective_scan_grouped_bwd.launches += 1
        io = u.dtype
        return (du, ddelta, dA_part.sum(0), dB_part.sum(0).to(io),
                dC_part.sum(0).to(io), dD_part.sum(0), ddb_part.sum(0))


@_bwd_op.register_fake
def _bwd_fake(u, delta, A, B, C, D, delta_bias, cs, gy, softplus):
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy)
    _on_cuda(*args, cs, gy)
    return tuple(torch.empty_like(t) for t in args)


def selective_scan_grouped_fwd_states(u, delta, A, B, C, D, delta_bias,
                                      softplus=True):
    """The training forward -> (y in the dtype of ``u``, fp32 cs): the op
    ``mamba_unet::selective_scan_grouped_fwd_states``.

    CPU tensors run :func:`selective_scan_grouped_states_ref`; CUDA tensors
    launch the forward kernel with state saving on, or raise. Each launch
    adds one to ``selective_scan_grouped_fwd_states.launches``."""
    return _fwd_states_op(u, delta, A, B, C, D, delta_bias, softplus)


def selective_scan_grouped_bwd(u, delta, A, B, C, D, delta_bias, cs, gy,
                               softplus=True):
    """The backward -> (du, ddelta, dA, dB, dC, dD, ddelta_bias), each in
    its operand's dtype (the kernel accumulates in fp32): the op
    ``mamba_unet::selective_scan_grouped_bwd``.

    ``cs`` is the state-saving forward's second output and ``gy`` the
    cotangent of its y, in the I/O dtype. CPU tensors run
    :func:`selective_scan_grouped_bwd_ref` (which recomputes instead of
    reading ``cs``); CUDA tensors launch the backward kernel and reduce its
    fp32 partial sums (over channel tiles for dB/dC, over the batch for
    dA/dD/ddelta_bias: a fixed order, so the result is deterministic), or
    raise. Each launch adds one to ``selective_scan_grouped_bwd.launches``."""
    return _bwd_op(u, delta, A, B, C, D, delta_bias, cs, gy, softplus)


class _ScanGrouped(torch.autograd.Function):
    """The training scan: the state-saving forward, and the backward kernel
    on the cotangent rounded to the I/O dtype."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, softplus):
        y, cs = selective_scan_grouped_fwd_states(u, delta, A, B, C, D,
                                                  delta_bias, softplus)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, cs)
        ctx.softplus = softplus
        return y

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        grads = selective_scan_grouped_bwd(
            *saved, gy.to(saved[0].dtype).contiguous(), ctx.softplus)
        return (*grads, None)


def selective_scan_grouped(u, delta, A, B, C, D, delta_bias, softplus=True,
                           return_last_state=False):
    """Time-major grouped scan -> y (B, G, L, dg) in the dtype of ``u``, or
    (y, fp32 last state (B, G * dg, N)) with ``return_last_state``.

    With grad enabled and an operand that requires grad, this is the
    differentiable training scan: the state-saving forward and the backward
    (kernels on CUDA tensors, their plain versions on CPU tensors); it has
    no ``return_last_state`` (prefill runs under ``torch.no_grad``).
    Otherwise it is the serving forward, the op
    ``mamba_unet::selective_scan_grouped``: CPU tensors run
    :func:`selective_scan_grouped_ref`, CUDA tensors launch the kernel on the
    current stream, or raise: there is no fallback. Each serving launch adds
    one to ``selective_scan_grouped.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if return_last_state:
            raise ValueError("return_last_state is a serving option: run "
                             "the prefill under torch.no_grad()")
        return _ScanGrouped.apply(*args, softplus)
    y, last = _serve_op(*args, softplus, return_last_state)
    return (y, last) if return_last_state else y


selective_scan_grouped.launches = 0
selective_scan_grouped_fwd_states.launches = 0
selective_scan_grouped_bwd.launches = 0
