"""Profiling and FLOP accounting.

Port of ``mamba_unet_tpu/utils/profiling.py``:

* :func:`selective_scan_flops` - the analytical scan FLOPs (the formula of
  the reference's ``flops_selective_scan_ref``, as the JAX module has it);
* :func:`model_flops` / :func:`compiled_cost` - where JAX asks XLA's cost
  analysis of the compiled program, the port counts with
  ``torch.utils.flop_counter.FlopCounterMode`` while the function runs.
  That counter knows the matrix products and convolutions (and
  attention); the port's scan ops (``torch.ops.mamba_unet.*``) get a
  formula here, built from :func:`selective_scan_flops`, so the count
  includes the scans instead of leaving them out. What differs from XLA's
  cost analysis: XLA also counts elementwise operations, reductions and
  transcendental functions, and reports the bytes accessed; this count has
  no bytes (``bytes_accessed`` is None) and no elementwise work. A scan's
  backward op counts twice its forward's FLOPs (it recomputes the forward
  and runs the adjoint recurrence, the same operations again);
* :func:`time_fn` - mean ms per call, synchronizing the card around the
  timed calls (the JAX version forces a host transfer);
* :func:`profile_trace` - a ``torch.profiler`` trace of the CPU and the
  card into ``logdir`` (a Chrome trace, and the table of kernels by device
  time in ``logdir/key_averages.txt``);
* :func:`parameter_count`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from mamba_unet_torch import ops as _ops  # noqa: F401  registers the ops


def selective_scan_flops(B: int, L: int, D: int, N: int, with_D: bool = True,
                         with_z: bool = False, with_group: bool = True) -> int:
    """Analytical scan FLOPs, matching flops_selective_scan_ref
    (mamba_sys.py:30-146): 9*B*L*D*N for the einsum core (grouped B/C) plus
    the optional D-skip and z-gate terms."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_z:
        flops += B * D * L
    return flops


# Every scan op takes (u, delta, A, ...) with delta holding one value per
# scanned (batch, direction, channel, step): B * L * D of the formula.
def _scan_fwd_flops(u_shape, delta_shape, A_shape, *args, out_shape=None,
                    **kwargs) -> int:
    lanes_steps = 1
    for s in delta_shape:
        lanes_steps *= s
    return selective_scan_flops(1, lanes_steps, 1, A_shape[-1])


def _scan_bwd_flops(*args, **kwargs) -> int:
    return 2 * _scan_fwd_flops(*args, **kwargs)


_SCAN_OPS = torch.ops.mamba_unet
register_flop_formula([
    _SCAN_OPS.selective_scan_grouped, _SCAN_OPS.selective_scan_grouped_fwd_states,
    _SCAN_OPS.selective_scan_bidir, _SCAN_OPS.selective_scan_bidir_fwd_states,
    _SCAN_OPS.selective_scan_folded_fwd,
    _SCAN_OPS.selective_scan_folded_fwd_states])(_scan_fwd_flops)
register_flop_formula([
    _SCAN_OPS.selective_scan_grouped_bwd, _SCAN_OPS.selective_scan_bidir_bwd,
    _SCAN_OPS.selective_scan_folded_bwd])(_scan_bwd_flops)
SCAN_OP_NAMES = ("selective_scan_grouped", "selective_scan_bidir",
                 "selective_scan_folded")


def compiled_cost(fn: Callable, *args) -> Dict[str, Optional[float]]:
    """FLOPs of one call ``fn(*args)``, counted as it runs: ``flops`` (all
    counted operations), ``scan_flops`` (those of the scan ops) and
    ``bytes_accessed`` (None: not counted)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    by_op = counter.get_flop_counts().get("Global", {})
    scan = sum(v for k, v in by_op.items()
               if any(name in str(k) for name in SCAN_OP_NAMES))
    return {"flops": float(counter.get_total_flops()),
            "scan_flops": float(scan), "bytes_accessed": None}


def model_flops(model: torch.nn.Module, *inputs) -> Dict[str, Optional[float]]:
    """Forward FLOPs of ``model`` on ``inputs`` (the VSSM.flops
    equivalent), without grad."""
    with torch.no_grad():
        return compiled_cost(model, *inputs)


def _sync(device=None) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean ms per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, the card synchronized before and after the timed
    calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters * 1000.0


@contextlib.contextmanager
def profile_trace(logdir: str):
    """``torch.profiler`` trace of the block (the CPU, and the card when
    there is one) into ``logdir/trace.json``, with the kernels by device
    time in ``logdir/key_averages.txt``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=30))


def parameter_count(params: Union[torch.nn.Module,
                                  Iterable[torch.Tensor]]) -> int:
    """Number of values of a module's parameters, or of the tensors
    given."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(int(p.numel()) for p in params)
