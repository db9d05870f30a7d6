"""SS2D — the 2-D selective-scan (visual Mamba) token mixer, channels-last.

Port of the bidirectional and time-major branches of
``mamba_unet_tpu/nn/ss2d.py``::

  in_proj D -> 2*d_inner, split (x, z)
  depthwise 3x3 conv + SiLU on x
  bidir (scan_impl "auto", "bidir"):
    row / column streams (B, 2, L, d_inner)
    per-direction x_proj (k = 2*j + m: stream m, reversal j) -> dt, B, C
    dt_projs -> bidirectional scan (pair-summed, fp32) -> row + col merge
  tm (scan_impl "tm", "pallas"):
    cross-scan: [row, col, row-rev, col-rev] copies (B, 4, L, d_inner)
    per-direction x_proj (direction k) -> dt, B, C
    dt_projs -> grouped scan, G = 4 (y in the compute dtype) -> cross-merge
  LayerNorm -> * silu(z) -> out_proj

Direction k of the tm branch is direction 2*j + m of the bidir branch, so
both compute the same function of the same weights. The bidir scan is
``selective_scan_bidir``, the tm scan ``selective_scan_grouped``: CUDA
kernels on CUDA tensors, their plain versions on CPU tensors. The JAX
package's other scan routes (``xla``, ``folded``, the sharded ones) are not
ported yet. Parameter names follow the upstream torch
checkpoints (``in_proj``, ``conv2d``, ``x_proj_weight``, ``dt_projs_weight``,
``dt_projs_bias``, ``A_logs``, ``Ds``, ``out_norm``, ``out_proj``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mamba_unet_torch.nn.layers import lecun_normal_, linear, uniform_
from mamba_unet_torch.ops.cross_scan import (
    cross_merge_tm,
    cross_scan_tm,
    merge_row_col,
    row_col_streams,
)
from mamba_unet_torch.ops.selective_scan_bidir import selective_scan_bidir
from mamba_unet_torch.ops.selective_scan_grouped import selective_scan_grouped

K = 4  # scan directions: [row, col, row-reversed, col-reversed]
# Fixed hyper-parameters of the Mamba-UNet SS2D (the JAX module's defaults,
# which no caller overrides): inner width = 2 * d_model, 3x3 depthwise conv
# with bias, no bias on the projections, dt_rank = ceil(d_model / 16),
# softplus(dt bias) ~ LogUniform(DT_MIN, DT_MAX) floored at DT_INIT_FLOOR.
EXPAND, D_CONV = 2, 3
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
# scan_impl values of the JAX SS2D that the port runs: the bidirectional
# branch and the time-major one; and those it does not run yet, with what
# each waits for
BIDIR_IMPLS, TM_IMPLS = ("auto", "bidir"), ("tm", "pallas")
_KERNELS_5_6 = "TPU kernels #5/#6 (the batch-folded scan), last in the queue"
_PARALLELISM = "the parallelism item (ROADMAP.md, queue 1, item 17)"
NOT_PORTED = {"folded": _KERNELS_5_6, "hwbc_folded": _KERNELS_5_6,
              "xla": _PARALLELISM, "seq_sharded": _PARALLELISM,
              "tp_sharded": _PARALLELISM}


def check_scan_impl(scan_impl: str) -> None:
    """Raise unless SS2D runs ``scan_impl``: ``NotImplementedError`` for a
    route of the JAX SS2D that is not ported yet, ``ValueError`` for any
    other value."""
    ported = ", ".join(BIDIR_IMPLS + TM_IMPLS)
    if scan_impl in NOT_PORTED:
        raise NotImplementedError(
            f"SS2D scan_impl={scan_impl!r} is not ported yet: it waits for "
            f"{NOT_PORTED[scan_impl]} (ported: {ported})")
    if scan_impl not in BIDIR_IMPLS + TM_IMPLS:
        raise ValueError(f"unknown SS2D scan_impl {scan_impl!r}; ported: "
                         f"{ported}")


def dt_bias_init(shape, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Softplus-inverse of a log-uniform sample in [DT_MIN, DT_MAX], so that
    softplus(bias) ~ LogUniform(DT_MIN, DT_MAX)."""
    u = torch.rand(shape, generator=generator)
    dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                   + math.log(DT_MIN)).clamp(min=DT_INIT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


def a_log_init(n_rows: int, d_state: int) -> torch.Tensor:
    """S4D-real init: A_log[r, n] = log(n + 1), so A = -exp(A_log)."""
    return torch.log(torch.arange(1, d_state + 1,
                                  dtype=torch.float32)).repeat(n_rows, 1)


class SS2D(nn.Module):
    def __init__(self, d_model: int, d_state: int = 16,
                 scan_impl: str = "auto", *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_scan_impl(scan_impl)
        self.scan_impl = scan_impl
        self.d_inner = d_inner = EXPAND * d_model
        self.dt_rank = dt_rank = math.ceil(d_model / 16)
        self.d_state = n = d_state

        self.in_proj = linear(d_model, 2 * d_inner, False, device, generator)
        self.conv2d = nn.Conv2d(d_inner, d_inner, D_CONV, padding=D_CONV // 2,
                                groups=d_inner, device=device)
        lecun_normal_(self.conv2d.weight, generator)
        nn.init.zeros_(self.conv2d.bias)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.x_proj_weight = param(K, dt_rank + 2 * n, d_inner)
        uniform_(self.x_proj_weight, 1.0 / math.sqrt(d_inner), generator)
        self.dt_projs_weight = param(K, d_inner, dt_rank)
        uniform_(self.dt_projs_weight, dt_rank ** -0.5, generator)
        self.dt_projs_bias = param(K, d_inner)
        with torch.no_grad():
            self.dt_projs_bias.copy_(dt_bias_init((K, d_inner), generator))
            self.A_logs = param(K * d_inner, n)
            self.A_logs.copy_(a_log_init(K * d_inner, n))
        self.Ds = nn.Parameter(torch.ones(K * d_inner, device=device))

        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5, device=device)
        self.out_proj = linear(d_inner, d_model, False, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_model) -> (B, H, W, d_model)."""
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        xx = F.silu(self.conv2d(xx.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        if self.scan_impl in TM_IMPLS:
            y = self._scan_tm(xx)
        else:
            y = self._scan_bidir(xx)
        return self.out_proj(self.out_norm(y) * F.silu(z))

    def _scan_bidir(self, xx: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_inner) -> fp32 (B, H, W, d_inner): the two data
        streams, each scanned both ways by the bidirectional kernel."""
        bsz, H, W, _ = xx.shape
        L, d, R, n = H * W, self.d_inner, self.dt_rank, self.d_state
        xs2 = row_col_streams(xx)                               # (B, 2, L, d)

        # direction k = 2*j + m reads stream m: W[k] regroups as (j, m, c, d)
        Wg = self.x_proj_weight.to(xs2.dtype).reshape(2, 2, R + 2 * n, d)
        x_dbl = torch.einsum("bmld,jmcd->bjmlc", xs2, Wg).reshape(
            bsz, K, L, R + 2 * n)
        dts, Bs, Cs = x_dbl.split([R, n, n], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts,
                           self.dt_projs_weight.to(dts.dtype))
        ys = selective_scan_bidir(
            xs2, dts.contiguous(), -torch.exp(self.A_logs.float()),
            Bs.contiguous(), Cs.contiguous(), self.Ds.float(),
            self.dt_projs_bias.float().reshape(-1),
        )                                                       # (B, 2, L, d)
        return merge_row_col(ys, H, W)

    def _scan_tm(self, xx: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_inner) -> fp32 (B, H, W, d_inner): the four direction
        copies, scanned time-major by the grouped kernel (G = 4)."""
        H, W = xx.shape[1:3]
        R, n = self.dt_rank, self.d_state
        xs = cross_scan_tm(xx)                                  # (B, 4, L, d)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs,
                             self.x_proj_weight.to(xs.dtype))
        dts, Bs, Cs = x_dbl.split([R, n, n], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts,
                           self.dt_projs_weight.to(dts.dtype))
        ys = selective_scan_grouped(
            xs.contiguous(), dts.contiguous(), -torch.exp(self.A_logs.float()),
            Bs.contiguous(), Cs.contiguous(), self.Ds.float(),
            self.dt_projs_bias.float().reshape(-1), True,
        )                                                       # (B, 4, L, d)
        return cross_merge_tm(ys.float(), H, W)
