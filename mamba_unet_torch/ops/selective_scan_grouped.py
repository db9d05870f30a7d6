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

Each counts its launches in ``.launches``, and those of its carry variant
(with ``x_init``, a last state that carries a gradient, or ``g_last``) in
``.carry_launches`` too.

:func:`selective_scan_grouped` picks at call time: with grad enabled and an
operand that requires grad it runs the two training entry points through a
``torch.autograd.Function``, otherwise the serving kernel.

Every entry point takes an optional incoming state ``x_init``: the scan
starts from it instead of zero (the carry that a sequence-sharded scan,
``parallel/seq_scan.py``, hands from the earlier shards; the XLA scan's
``x_init`` in ``mamba_unet_tpu/ops/selective_scan.py``). The training
forward can also return its last state, and the backward takes that
state's cotangent ``g_last`` and returns ``x_init``'s, so a carry over L
is differentiable end to end on the kernels.

================  ==================  =============
operand           shape               dtype
================  ==================  =============
u, delta          (B, G, L, dg)       fp32 or bf16
B, C              (B, G, L, N)        as u
A                 (G * dg, N)         fp32
D, delta_bias     (G * dg,)           fp32
y, gy             (B, G, L, dg)       as u
last state        (B, G * dg, N)      fp32
x_init, g_last    (B, G * dg, N)      fp32
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
from typing import Optional

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
           state_chunk=0, x_init=None):
    """``ops/selective_scan.py``'s sequential fp32 loop on the (B, D, L)
    view of the time-major operands; y back in (B, G, L, dg)."""
    # imported here: ops/selective_scan.py imports this module
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref

    bsz, G, L, dg = u.shape
    out = selective_scan_ref(
        _channels_first(u), _channels_first(delta), A, B.transpose(2, 3),
        C.transpose(2, 3), D, None, delta_bias, softplus, return_last_state,
        state_chunk=state_chunk, x_init=x_init)
    y, *extra = out if isinstance(out, tuple) else (out,)
    return (y.reshape(bsz, G, dg, L).transpose(2, 3), *extra)


def selective_scan_grouped_ref(u, delta, A, B, C, D, delta_bias,
                               softplus=True, return_last_state=False,
                               x_init=None):
    """Plain version of the forward, from ``x_init`` or zero: y in the
    dtype of ``u``, and with ``return_last_state`` also the fp32
    (B, G * dg, N) state after step L."""
    out = _plain(u, delta, A, B, C, D, delta_bias, softplus,
                 return_last_state, x_init=x_init)
    return out if return_last_state else out[0]


def selective_scan_grouped_states_ref(u, delta, A, B, C, D, delta_bias,
                                      softplus=True, x_init=None,
                                      return_last_state=False):
    """Plain version of the state-saving forward, from ``x_init`` or
    zero -> (y in the dtype of ``u``, cs[, last state]): cs[:, g, c] is
    the fp32 (N, dg) state of group g entering step c * STATE_CHUNK."""
    bsz, G, L, dg = u.shape
    y, *last, states = _plain(u, delta, A, B, C, D, delta_bias, softplus,
                              return_last_state, STATE_CHUNK, x_init)
    cs = states.reshape(bsz, -1, G, dg, A.shape[-1]).permute(0, 2, 1, 4, 3)
    return (y, cs.contiguous(), *last)


def selective_scan_grouped_bwd_ref(u, delta, A, B, C, D, delta_bias, gy,
                                   softplus=True, x_init=None, g_last=None):
    """Plain version of the backward: ``ops/selective_scan.py``'s
    reverse-time loop (``selective_scan_ref_bwd``, no autograd) on the
    (B, D, L) view, for the cotangent ``gy`` of y and ``g_last`` of the
    last state (None: zero), from ``x_init`` or zero. Returns the seven
    gradients, each in its operand's dtype, and with an ``x_init`` last
    also its fp32 cotangent."""
    # imported here: ops/selective_scan.py imports this module
    from mamba_unet_torch.ops.selective_scan import selective_scan_ref_bwd

    bsz, G, L, dg = u.shape
    du, ddelta, dA, dB, dC, dD, ddb, *dx = selective_scan_ref_bwd(
        _channels_first(u), _channels_first(delta), A, B.transpose(2, 3),
        C.transpose(2, 3), D, delta_bias, softplus, _channels_first(gy),
        x_init, g_last)

    def time_major(t):  # (B, G * dg, L) -> (B, G, L, dg)
        return t.reshape(bsz, G, dg, L).transpose(2, 3)

    grads = (time_major(du), time_major(ddelta), dA, dB.transpose(2, 3),
             dC.transpose(2, 3), dD, ddb)
    args = (u, delta, A, B, C, D, delta_bias)
    return tuple(g.to(t.dtype).contiguous() for g, t in zip(grads, args)
                 ) + tuple(dx)


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


def _ptr(t):
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _launch_fwd(args, softplus, x_init, last, cs):
    """Launch the forward kernel from ``x_init`` (None: zero) -> y;
    ``last`` and ``cs`` are its optional fp32 outputs (None: not
    written)."""
    u, delta, A, B, C, D, delta_bias = args
    bsz, G, L, dg = u.shape
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u.device):
        y = torch.empty_like(u)
        err = lib.selective_scan_fwd(
            u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), _ptr(x_init),
            y.data_ptr(), _ptr(last), _ptr(cs), bsz, G, L, dg,
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


def _check_state(name, t, u, A):
    """An incoming state or a last state's cotangent: None, or fp32
    (B, G * dg, N) beside ``u``."""
    if t is None:
        return
    bsz, G, L, dg = u.shape
    want = (bsz, G * dg, A.shape[-1])
    if tuple(t.shape) != want or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 {want}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _check_bwd(args, cs, gy, x_init=None, g_last=None):
    """The backward's operand checks: :func:`_check`, then ``cs``, ``gy``
    and the optional states."""
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
    _check_state("x_init", x_init, u, args[2])
    _check_state("g_last", g_last, u, args[2])


def _no_last_state(u):
    """An op's state output when it is not asked for."""
    return u.new_empty(0, dtype=torch.float32)


def _state_out(u, A):
    """An empty fp32 (B, G * dg, N) state beside ``u``."""
    bsz, G, L, dg = u.shape
    return u.new_empty(bsz, G * dg, A.shape[-1], dtype=torch.float32)


def _present(*tensors):
    """The tensors that are not None."""
    return [t for t in tensors if t is not None]


# The three kernel entry points as custom ops: a CPU implementation (the
# plain version), a CUDA one (the kernel, or raise) and a fake one (shapes
# and dtypes only, for torch.export). The checks run in all three. The
# incoming state and the last state's cotangent are optional arguments;
# an output that is not asked for is an empty tensor.

@torch.library.custom_op("mamba_unet::selective_scan_grouped",
                         mutates_args=(), device_types="cpu")
def _serve_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              delta_bias: torch.Tensor, softplus: bool,
              return_last_state: bool, x_init: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    y, *last = _plain(*args, softplus, return_last_state, x_init=x_init)
    return y.contiguous(), last[0] if last else _no_last_state(u)


@_serve_op.register_kernel("cuda")
def _serve_cuda(u, delta, A, B, C, D, delta_bias, softplus,
                return_last_state, x_init=None):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    _on_cuda(*args, *_present(x_init))
    last = _state_out(u, A) if return_last_state else None
    y = _launch_fwd(args, softplus, x_init, last, None)
    selective_scan_grouped.launches += 1
    selective_scan_grouped.carry_launches += x_init is not None
    return y, _no_last_state(u) if last is None else last


@_serve_op.register_fake
def _serve_fake(u, delta, A, B, C, D, delta_bias, softplus,
                return_last_state, x_init=None):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    _on_cuda(*args, *_present(x_init))
    last = _state_out(u, A) if return_last_state else _no_last_state(u)
    return torch.empty_like(u), last


@torch.library.custom_op("mamba_unet::selective_scan_grouped_fwd_states",
                         mutates_args=(), device_types="cpu")
def _fwd_states_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   delta_bias: torch.Tensor, softplus: bool,
                   x_init: Optional[torch.Tensor] = None,
                   return_last_state: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    y, cs, *last = selective_scan_grouped_states_ref(
        *args, softplus, x_init, return_last_state)
    return y.contiguous(), cs, last[0] if last else _no_last_state(u)


@_fwd_states_op.register_kernel("cuda")
def _fwd_states_cuda(u, delta, A, B, C, D, delta_bias, softplus,
                     x_init=None, return_last_state=False):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    _on_cuda(*args, *_present(x_init))
    bsz, G, L, dg = u.shape
    cs = torch.empty(bsz, G, -(-L // STATE_CHUNK), KERNEL_N, dg,
                     dtype=torch.float32, device=u.device)
    last = _state_out(u, A) if return_last_state else None
    y = _launch_fwd(args, softplus, x_init, last, cs)
    selective_scan_grouped_fwd_states.launches += 1
    selective_scan_grouped_fwd_states.carry_launches += (
        x_init is not None or return_last_state)
    return y, cs, _no_last_state(u) if last is None else last


@_fwd_states_op.register_fake
def _fwd_states_fake(u, delta, A, B, C, D, delta_bias, softplus,
                     x_init=None, return_last_state=False):
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args)
    _check_state("x_init", x_init, u, A)
    _on_cuda(*args, *_present(x_init))
    bsz, G, L, dg = u.shape
    last = _state_out(u, A) if return_last_state else _no_last_state(u)
    return torch.empty_like(u), u.new_empty(
        bsz, G, -(-L // STATE_CHUNK), A.shape[-1], dg,
        dtype=torch.float32), last


@torch.library.custom_op("mamba_unet::selective_scan_grouped_bwd",
                         mutates_args=(), device_types="cpu")
def _bwd_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            delta_bias: torch.Tensor, cs: torch.Tensor, gy: torch.Tensor,
            softplus: bool, x_init: Optional[torch.Tensor] = None,
            g_last: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy, x_init, g_last)
    grads = selective_scan_grouped_bwd_ref(*args, gy, softplus, x_init,
                                           g_last)
    return grads if x_init is not None else grads + (_no_last_state(u),)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(u, delta, A, B, C, D, delta_bias, cs, gy, softplus,
              x_init=None, g_last=None):
    # the kernel reads the incoming state from cs (chunk 0's entry state)
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy, x_init, g_last)
    _on_cuda(*args, cs, gy, *_present(x_init, g_last))
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
        dx_init = None if x_init is None else _state_out(u, A)
        err = lib.selective_scan_bwd(
            u.data_ptr(), delta.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), cs.data_ptr(),
            gy.data_ptr(), du.data_ptr(), ddelta.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
            dD_part.data_ptr(), ddb_part.data_ptr(), _ptr(g_last),
            _ptr(dx_init), bsz, G, L, dg, n, int(bool(softplus)),
            int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "selective_scan_bwd")
        selective_scan_grouped_bwd.launches += 1
        selective_scan_grouped_bwd.carry_launches += (
            x_init is not None or g_last is not None)
        io = u.dtype
        return (du, ddelta, dA_part.sum(0), dB_part.sum(0).to(io),
                dC_part.sum(0).to(io), dD_part.sum(0), ddb_part.sum(0),
                _no_last_state(u) if dx_init is None else dx_init)


@_bwd_op.register_fake
def _bwd_fake(u, delta, A, B, C, D, delta_bias, cs, gy, softplus,
              x_init=None, g_last=None):
    args = (u, delta, A, B, C, D, delta_bias)
    _check_bwd(args, cs, gy, x_init, g_last)
    _on_cuda(*args, cs, gy, *_present(x_init, g_last))
    dx = _no_last_state(u) if x_init is None else _state_out(u, A)
    return tuple(torch.empty_like(t) for t in args) + (dx,)


def selective_scan_grouped_fwd_states(u, delta, A, B, C, D, delta_bias,
                                      softplus=True, x_init=None,
                                      return_last_state=False):
    """The training forward, from ``x_init`` (fp32 (B, G * dg, N); None:
    zero) -> (y in the dtype of ``u``, fp32 cs), and with
    ``return_last_state`` also the fp32 last state: the op
    ``mamba_unet::selective_scan_grouped_fwd_states``.

    CPU tensors run :func:`selective_scan_grouped_states_ref`; CUDA tensors
    launch the forward kernel with state saving on, or raise. Each launch
    adds one to ``selective_scan_grouped_fwd_states.launches``."""
    y, cs, last = _fwd_states_op(u, delta, A, B, C, D, delta_bias, softplus,
                                 x_init, return_last_state)
    return (y, cs, last) if return_last_state else (y, cs)


def selective_scan_grouped_bwd(u, delta, A, B, C, D, delta_bias, cs, gy,
                               softplus=True, x_init=None, g_last=None):
    """The backward -> (du, ddelta, dA, dB, dC, dD, ddelta_bias), each in
    its operand's dtype (the kernel accumulates in fp32), and with an
    ``x_init`` last also its fp32 cotangent: the op
    ``mamba_unet::selective_scan_grouped_bwd``.

    ``cs`` is the state-saving forward's second output (its chunk 0 holds
    ``x_init``) and ``gy`` the cotangent of its y, in the I/O dtype;
    ``g_last`` is the fp32 cotangent of its last state (None: zero). CPU
    tensors run :func:`selective_scan_grouped_bwd_ref` (which recomputes
    from ``x_init`` instead of reading ``cs``); CUDA tensors launch the
    backward kernel and reduce its fp32 partial sums (over channel tiles
    for dB/dC, over the batch for dA/dD/ddelta_bias: a fixed order, so the
    result is deterministic), or raise. Each launch adds one to
    ``selective_scan_grouped_bwd.launches``."""
    *grads, dx = _bwd_op(u, delta, A, B, C, D, delta_bias, cs, gy, softplus,
                         x_init, g_last)
    return tuple(grads) if x_init is None else (*grads, dx)


class _ScanGrouped(torch.autograd.Function):
    """The training scan, from an optional incoming state, with an
    optional last state: the state-saving forward, and the backward kernel
    on the cotangent rounded to the I/O dtype and the last state's fp32
    cotangent."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, x_init, softplus,
                return_last_state):
        out = selective_scan_grouped_fwd_states(
            u, delta, A, B, C, D, delta_bias, softplus, x_init,
            return_last_state)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, out[1],
                              x_init)
        ctx.softplus = softplus
        ctx.set_materialize_grads(False)
        return (out[0], out[2]) if return_last_state else out[0]

    @staticmethod
    def backward(ctx, gy, g_last=None):
        *args, cs, x_init = ctx.saved_tensors
        u = args[0]
        gy = torch.zeros_like(u) if gy is None else gy.to(u.dtype)
        grads = selective_scan_grouped_bwd(
            *args, cs, gy.contiguous(), ctx.softplus, x_init,
            None if g_last is None else g_last.float().contiguous())
        dx = grads[7] if x_init is not None else None
        return (*grads[:7], dx, None, None)


def selective_scan_grouped(u, delta, A, B, C, D, delta_bias, softplus=True,
                           return_last_state=False, x_init=None):
    """Time-major grouped scan from ``x_init`` (fp32 (B, G * dg, N); None:
    zero) -> y (B, G, L, dg) in the dtype of ``u``, or (y, fp32 last state
    (B, G * dg, N)) with ``return_last_state``.

    With grad enabled and an operand (``x_init`` too) that requires grad,
    this is the differentiable training scan: the state-saving forward and
    the backward (kernels on CUDA tensors, their plain versions on CPU
    tensors); the last state then carries a gradient, and so does
    ``x_init``. Otherwise it is the serving forward, the op
    ``mamba_unet::selective_scan_grouped``: CPU tensors run
    :func:`selective_scan_grouped_ref`, CUDA tensors launch the kernel on the
    current stream, or raise: there is no fallback. Each serving launch adds
    one to ``selective_scan_grouped.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in _present(*args, x_init)):
        return _ScanGrouped.apply(*args, x_init, softplus, return_last_state)
    y, last = _serve_op(*args, softplus, return_last_state, x_init)
    return (y, last) if return_last_state else y


selective_scan_grouped.launches = 0
selective_scan_grouped_fwd_states.launches = 0
selective_scan_grouped_bwd.launches = 0
# the launches of the carry variants among them: an incoming state (and,
# training, a last state or its cotangent)
selective_scan_grouped.carry_launches = 0
selective_scan_grouped_fwd_states.carry_launches = 0
selective_scan_grouped_bwd.carry_launches = 0
