"""Batch-folded selective scan for SS2D: CUDA kernels, plain versions,
wrappers.

Port of ``mamba_unet_tpu/ops/selective_scan_folded.py``, forward and VJP.
The operands are time-major with the batch folded into the channel axis:
lane l of the ``B * dg`` lanes is channel ``l % dg`` of batch ``l // dg``.
The CUDA kernel ``csrc/selective_scan_folded_fwd.cu`` replaces the TPU
kernel ``_fwd_kernel_folded`` (``_scan_fwd_folded``, without and with the
chunk-entry states ``cs``), ``csrc/selective_scan_folded_bwd.cu`` replaces
``_bwd_kernel_folded`` (``_scan_bwd_folded``).

Two public entries, as in the JAX module:

* :func:`selective_scan_folded_bidir` - SS2D's four directions [row, col,
  row-reversed, col-reversed] over the two data streams: direction g reads
  stream g % 2, and g >= 2 scans it in reversed time;
* :func:`selective_scan_folded` - G directions, each over its own stream,
  none reversed.

Each picks at call time: with grad enabled and an operand that requires
grad it runs the two training entry points through a
``torch.autograd.Function``, otherwise the serving forward. The three kernel
entry points, each with its plain version and launch count:

* :func:`selective_scan_folded_fwd` - the serving forward;
* :func:`selective_scan_folded_fwd_states` - the forward that also writes
  the fp32 state entering every ``STATE_CHUNK``-step chunk of data time;
* :func:`selective_scan_folded_bwd` - the backward from those states.

================  ==================  =============
operand           shape               dtype
================  ==================  =============
u                 (S, L, B * dg)      fp32 or bf16; S = 2 (bidir) or G
delta             (G, L, B * dg)      as u
B, C              (G, L, N, B)        as u
A                 (G * dg, N)         fp32
D, delta_bias     (G * dg,)           fp32
y, gy             (G, L, B * dg)      as u; one slab per direction, in
                                      data order, not pair-summed
cs                (G, nc, N, B * dg)  fp32, nc = ceil(L / STATE_CHUNK)
================  ==================  =============

cs[g, c] is the state of direction g entering data chunk c (steps
[16c, 16c + 16)) in its scan order: after the steps before 16c for a
forward direction, after the steps from 16c + 16 on for a reversed one. The
chunks are fixed in data time for both, as the TPU kernel's are. ``delta``
goes through delta + delta_bias, then softplus when ``softplus`` is set;
the state and all arithmetic are fp32 (the TPU kernel keeps the states of a
chunk, and ``cs``, in the I/O dtype), and y is rounded to the I/O dtype
once. The backward returns du summed over each pair of directions that
reads one stream (bidir), dB/dC in the I/O dtype, and dA/dD/ddelta_bias
reduced over the batch. Unlike the TPU wrapper, the kernels take any
batch: the TPU needs B * dg to be a multiple of 128 lanes, the card does
not.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mamba_unet_torch.ops import _build
from mamba_unet_torch.ops.selective_scan_bidir import OCCUPANCY_KEYS

KERNEL_N = 16  # the d_state the CUDA kernels are compiled for
STATE_CHUNK = 16  # data steps between saved states (kStateChunk in the .cuh)
# channels of one batch per dB/dC partial of the backward: a group's kCh
# (bidirectional: a block is a direction pair) or a block's 2 * kCh
KERNEL_TILE = {True: 16, False: 32}
ARG_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _scan_order(x, bidir):
    """(G, L, ...) in data order -> scan order (reversed directions flipped
    in time); its own inverse."""
    return torch.cat([x[:2], x[2:].flip(1)]) if bidir else x


def _plain(u, delta, A, B, C, D, delta_bias, softplus, bidir,
           save_states=False):
    """Sequential fp32 loop over scan steps of all directions at once ->
    y in the dtype of ``u``, and with ``save_states`` also cs."""
    G, L, BD = delta.shape
    bsz = B.shape[-1]
    dg, n = BD // bsz, A.shape[-1]

    def per_batch(t):  # (·, L, B * dg) -> fp32 (·, L, B, dg)
        return t.float().reshape(t.shape[0], L, bsz, dg)

    uu = per_batch(u)
    if bidir:
        uu = uu[[0, 1, 0, 1]]
    dt = per_batch(delta) + delta_bias.float().reshape(G, 1, 1, dg)
    if softplus:
        dt = F.softplus(dt)
    uu, dt = _scan_order(uu, bidir), _scan_order(dt, bidir)
    Bs = _scan_order(B.float().transpose(2, 3), bidir)      # (G, L, B, N)
    Cs = _scan_order(C.float().transpose(2, 3), bidir)
    A_g = A.float().reshape(G, 1, dg, n)
    x = uu.new_zeros(G, bsz, dg, n)
    nf = 2 if bidir else G  # directions scanned forward in time
    ys, fwd_cs, rev_cs = [], [], []
    for p in range(L):
        if save_states:
            lanes = x.permute(0, 3, 1, 2).reshape(G, n, BD)
            if p % STATE_CHUNK == 0:
                fwd_cs.append(lanes[:nf])
            # a reversed direction is at data step L - 1 - p: it enters a
            # chunk at its first step and at each step 16c + 15
            if nf < G and (p == 0 or (L - p) % STATE_CHUNK == 0):
                rev_cs.append(lanes[nf:])
        d_p = dt[:, p, :, :, None]                             # (G,B,dg,1)
        x = torch.exp(d_p * A_g) * x + d_p * uu[:, p, :, :, None] * Bs[
            :, p, :, None, :]
        ys.append(torch.einsum("gbdn,gbn->gbd", x, Cs[:, p]))
    y = torch.stack(ys, dim=1) + uu * D.float().reshape(G, 1, 1, dg)
    y = _scan_order(y, bidir).reshape(G, L, BD).to(u.dtype)
    if not save_states:
        return y
    # a reversed direction enters its data chunks from the last to the first
    cs = torch.stack(fwd_cs, dim=1)
    if rev_cs:
        cs = torch.cat([cs, torch.stack(rev_cs[::-1], dim=1)])
    return y, cs


def selective_scan_folded_ref(u, delta, A, B, C, D, delta_bias,
                              softplus=True, bidir=True):
    """Plain version of the forward: y (G, L, B * dg) in the dtype of ``u``.
    ``bidir`` is the contract of :func:`selective_scan_folded_bidir` (u holds
    two streams, directions 2 and 3 reversed), otherwise that of
    :func:`selective_scan_folded`."""
    return _plain(u, delta, A, B, C, D, delta_bias, softplus, bidir)


def selective_scan_folded_states_ref(u, delta, A, B, C, D, delta_bias,
                                     softplus=True, bidir=True):
    """Plain version of the state-saving forward -> (y in the dtype of
    ``u``, fp32 cs (G, nc, N, B * dg))."""
    return _plain(u, delta, A, B, C, D, delta_bias, softplus, bidir, True)


def selective_scan_folded_bwd_ref(u, delta, A, B, C, D, delta_bias, gy,
                                  softplus=True, bidir=True):
    """Plain version of the backward: autograd through
    :func:`selective_scan_folded_ref` on fp32 copies, for the cotangent
    ``gy``. Returns the seven gradients, each in its operand's dtype (du
    pair-summed with ``bidir``, as u holds the two streams)."""
    args = (u, delta, A, B, C, D, delta_bias)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_() for t in args]
        y = selective_scan_folded_ref(*leaves, softplus, bidir)
        grads = torch.autograd.grad(y, leaves, gy.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, args))


def _check(u, delta, A, B, C, D, delta_bias, bidir):
    if delta.dim() != 3:
        raise ValueError(f"delta must be (G, L, B * dg), got "
                         f"{tuple(delta.shape)}")
    G, L, BD = delta.shape
    if bidir and G != 4:
        raise ValueError(f"the bidirectional scan has 4 directions, got {G}")
    if B.dim() != 4 or B.shape[-1] <= 0 or BD % B.shape[-1]:
        raise ValueError(f"B must be (G, L, N, batch) with batch dividing "
                         f"{BD} lanes, got {tuple(B.shape)}")
    bsz, n = B.shape[-1], A.shape[-1]
    dg = BD // bsz
    want = {
        "u": (u, (2 if bidir else G, L, BD)),
        "B": (B, (G, L, n, bsz)),
        "C": (C, (G, L, n, bsz)),
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
        raise ValueError("selective_scan_folded: CUDA operands must be "
                         "contiguous")
    n = tensors[2].shape[-1]
    if n != KERNEL_N:
        raise ValueError(f"the CUDA kernels are built for d_state={KERNEL_N}, "
                         f"got {n}")
    return True


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _dims(delta, B):
    """(G, L, batch, dg) of the folded operands."""
    G, L, BD = delta.shape
    return G, L, B.shape[-1], BD // B.shape[-1]


def _batch_major(B, C):
    """B/C (G, L, N, batch) -> contiguous (G, batch, L, N), the kernels'
    layout: a chunk's steps of one batch lie together for 16-byte copies."""
    return (t.permute(0, 3, 1, 2).contiguous() for t in (B, C))


def _launch_fwd(args, softplus, bidir, cs):
    """Launch the forward kernel -> y; ``cs`` is its optional fp32 output
    (None: not written)."""
    u, delta, A, B, C, D, delta_bias = args
    G, L, bsz, dg = _dims(delta, B)
    lib = _build.library()  # builds the kernels on first use
    with torch.cuda.device(u.device):
        y = torch.empty(delta.shape, dtype=u.dtype, device=u.device)
        Bt, Ct = _batch_major(B, C)
        err = lib.selective_scan_folded_fwd(
            u.data_ptr(), delta.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), y.data_ptr(),
            None if cs is None else cs.data_ptr(), bsz, G, L, dg,
            A.shape[-1], int(bool(bidir)), int(bool(softplus)),
            int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "selective_scan_folded_fwd")
    return y


def kernel_occupancy(kind: str, bsz: int, L: int, dg: int,
                     bidir: bool = True, bf16: bool = False) -> dict:
    """The launch configuration of the kernel that ``kind`` (``serve``,
    ``fwd_states`` or ``bwd``) launches at (bsz, L, dg) with 4 directions
    (bidirectional) or 4 streams, as the card reports it:
    ``selective_scan_bidir.OCCUPANCY_KEYS`` -> int. Needs a card."""
    lib = _build.library()
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    if kind == "bwd":
        err = lib.selective_scan_folded_bwd_occupancy(
            bsz, 4, L, dg, int(bidir), int(bf16), out)
    else:
        err = lib.selective_scan_folded_fwd_occupancy(
            bsz, 4, L, dg, int(bf16), int(kind == "fwd_states"), out)
    _raise_on(err, f"selective_scan_folded {kind} occupancy")
    return dict(zip(OCCUPANCY_KEYS, out))


def selective_scan_folded_fwd(u, delta, A, B, C, D, delta_bias,
                              softplus=True, bidir=True):
    """The serving forward -> y in the dtype of ``u``.

    CPU tensors run :func:`selective_scan_folded_ref`; CUDA tensors launch
    the forward kernel without saved states on the current stream, or
    raise: there is no fallback. Each launch adds one to
    ``selective_scan_folded_fwd.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args, bidir)
    if not _on_cuda(*args):
        return selective_scan_folded_ref(*args, softplus, bidir)
    y = _launch_fwd(args, softplus, bidir, None)
    selective_scan_folded_fwd.launches += 1
    return y


def selective_scan_folded_fwd_states(u, delta, A, B, C, D, delta_bias,
                                     softplus=True, bidir=True):
    """The training forward -> (y in the dtype of ``u``, fp32 cs).

    CPU tensors run :func:`selective_scan_folded_states_ref`; CUDA tensors
    launch the forward kernel with state saving on, or raise. Each launch
    adds one to ``selective_scan_folded_fwd_states.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args, bidir)
    if not _on_cuda(*args):
        return selective_scan_folded_states_ref(*args, softplus, bidir)
    G, L, BD = delta.shape
    cs = torch.empty(G, -(-L // STATE_CHUNK), KERNEL_N, BD,
                     dtype=torch.float32, device=u.device)
    y = _launch_fwd(args, softplus, bidir, cs)
    selective_scan_folded_fwd_states.launches += 1
    return y, cs


def selective_scan_folded_bwd(u, delta, A, B, C, D, delta_bias, cs, gy,
                              softplus=True, bidir=True):
    """The backward -> (du, ddelta, dA, dB, dC, dD, ddelta_bias), each in
    its operand's dtype (the kernel accumulates in fp32).

    ``cs`` is the state-saving forward's second output and ``gy`` the
    cotangent of its y, in the I/O dtype. CPU tensors run
    :func:`selective_scan_folded_bwd_ref` (which recomputes instead of
    reading ``cs``); CUDA tensors launch the backward kernel, which sums du
    over each pair of directions itself, and reduce its fp32 partial sums
    here in a fixed order (dB/dC over channel tiles, dA/dD/ddelta_bias over
    the batch: deterministic, no atomics), or raise. Each launch adds one to
    ``selective_scan_folded_bwd.launches``."""
    args = (u, delta, A, B, C, D, delta_bias)
    _check(*args, bidir)
    G, L, bsz, dg = _dims(delta, B)
    n = A.shape[-1]
    want = (G, -(-L // STATE_CHUNK), n, bsz * dg)
    if tuple(cs.shape) != want or cs.dtype != torch.float32:
        raise ValueError(f"cs must be float32 {want}, got {cs.dtype} "
                         f"{tuple(cs.shape)}")
    if tuple(gy.shape) != tuple(delta.shape) or gy.dtype != u.dtype:
        raise ValueError(f"gy must be {u.dtype} {tuple(delta.shape)}, got "
                         f"{gy.dtype} {tuple(gy.shape)}")
    if not _on_cuda(*args, cs, gy):
        return selective_scan_folded_bwd_ref(*args, gy, softplus, bidir)
    ntile = -(-dg // KERNEL_TILE[bool(bidir)])
    lib = _build.library()
    with torch.cuda.device(u.device):
        f32 = dict(dtype=torch.float32, device=u.device)
        du = torch.empty(u.shape, **f32)  # per stream: bidir pairs summed
        ddelta = torch.empty_like(delta)
        dB_part = torch.empty(ntile, G, bsz, L, n, **f32)
        dC_part = torch.empty(ntile, G, bsz, L, n, **f32)
        dA_part = torch.empty(bsz, G * dg, n, **f32)
        dD_part = torch.empty(bsz, G * dg, **f32)
        ddb_part = torch.empty(bsz, G * dg, **f32)
        Bt, Ct = _batch_major(B, C)
        err = lib.selective_scan_folded_bwd(
            u.data_ptr(), delta.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
            A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(), cs.data_ptr(),
            gy.data_ptr(), du.data_ptr(), ddelta.data_ptr(),
            dB_part.data_ptr(), dC_part.data_ptr(), dA_part.data_ptr(),
            dD_part.data_ptr(), ddb_part.data_ptr(), bsz, G, L, dg, n,
            int(bool(bidir)), int(bool(softplus)),
            int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "selective_scan_folded_bwd")
        selective_scan_folded_bwd.launches += 1
        io = u.dtype

        def per_batch_last(part):  # (ntile, G, B, L, N) -> (G, L, N, B)
            return part.sum(0).permute(0, 2, 3, 1).to(io).contiguous()

        return (du.to(io), ddelta, dA_part.sum(0), per_batch_last(dB_part),
                per_batch_last(dC_part), dD_part.sum(0), ddb_part.sum(0))


class _ScanFolded(torch.autograd.Function):
    """The training scan: the state-saving forward, and the backward kernel
    on the cotangent rounded to the I/O dtype."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, softplus, bidir):
        y, cs = selective_scan_folded_fwd_states(u, delta, A, B, C, D,
                                                 delta_bias, softplus, bidir)
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, cs)
        ctx.softplus, ctx.bidir = softplus, bidir
        return y

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        grads = selective_scan_folded_bwd(
            *saved, gy.to(saved[0].dtype).contiguous(), ctx.softplus,
            ctx.bidir)
        return (*grads, None, None)


def _scan(u, delta, A, B, C, D, delta_bias, softplus, bidir):
    """Cast as the JAX entries do (u/delta/B/C to the I/O dtype: bf16 for a
    bf16 ``u``, else fp32; A/D/delta_bias to fp32), then run the training
    scan under grad or the serving forward."""
    io = torch.bfloat16 if u.dtype == torch.bfloat16 else torch.float32
    args = [t.to(io).contiguous() for t in (u, delta)] + [
        A.float().contiguous()] + [t.to(io).contiguous() for t in (B, C)] + [
        t.float().contiguous() for t in (D, delta_bias)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _ScanFolded.apply(*args, softplus, bidir)
    return selective_scan_folded_fwd(*args, softplus, bidir)


def selective_scan_folded_bidir(u2, delta4, A, B4, C4, D, delta_bias,
                                softplus=True):
    """SS2D's 4-direction scan on batch-folded lanes -> y (4, L, B * dg),
    one slab per direction in data order, in the I/O dtype.

    ``u2`` (2, L, B * dg) holds the row and column streams; ``delta4``
    (4, L, B * dg) and ``B4``/``C4`` (4, L, N, B) are per direction in data
    order. With grad enabled and an operand that requires grad this is the
    differentiable training scan (kernels on CUDA tensors, plain versions
    on CPU tensors); otherwise the serving forward."""
    return _scan(u2, delta4, A, B4, C4, D, delta_bias, softplus, True)


def selective_scan_folded(u_f, delta_f, A, B_f, C_f, D, delta_bias,
                          softplus=True):
    """Unidirectional folded scan: direction g scans its own stream
    ``u_f[g]`` forward in time -> y (G, L, B * dg) in the I/O dtype. The
    same kernels as :func:`selective_scan_folded_bidir`, reversal off."""
    return _scan(u_f, delta_f, A, B_f, C_f, D, delta_bias, softplus, False)


selective_scan_folded_fwd.launches = 0
selective_scan_folded_fwd_states.launches = 0
selective_scan_folded_bwd.launches = 0
