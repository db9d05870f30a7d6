"""SS2D — the 2-D selective-scan (visual Mamba) token mixer, channels-last.

Port of the bidirectional, time-major and batch-folded branches of
``mamba_unet_tpu/nn/ss2d.py``::

  in_proj D -> 2*d_inner, split (x, z)
  depthwise 3x3 conv + SiLU on x
  bidir (scan_impl "auto", "bidir"):
    row / column streams (B, 2, L, d_inner)
    per-direction x_proj (k = 2*j + m: stream m, reversal j) -> dt, B, C
    dt_projs -> bidirectional scan (pair-summed, fp32) -> row + col merge
  tm (scan_impl "tm", "pallas", "xla"):
    cross-scan: [row, col, row-rev, col-rev] copies (B, 4, L, d_inner)
    per-direction x_proj (direction k) -> dt, B, C
    dt_projs -> grouped scan, G = 4 (y in the compute dtype) -> cross-merge
  folded (scan_impl "folded"):
    row / column streams time-major, batch folded into the lanes
    (2, L, B * d_inner)
    dt from one collapsed (d_inner, d_inner) matrix per direction
    (dt_projs @ x_proj's dt rows, in fp32), B and C from their own
    einsums (4, L, N, B)
    4-direction folded scan (one slab per direction, compute dtype) ->
    widened to fp32, pairs and row + col merged
  LayerNorm -> * silu(z) -> out_proj

Direction k of the tm and folded branches is direction 2*j + m of the
bidir branch, so all three compute the same function of the same weights
(the folded branch rounds dt differently: its collapsed matrix is one
product, not two). The JAX xla route computes the tm branch's function
channel-major, (B, 4, d_inner, L), through the public selective scan; the
port runs it as the tm branch, which launches the same grouped kernels
without the layout's transposes (it sums the directions in fp32 where the
JAX route sums y in the compute dtype). The scans are
``selective_scan_bidir``, ``selective_scan_grouped`` and
``selective_scan_folded_bidir``: CUDA kernels on CUDA tensors, their plain
versions on CPU tensors. The JAX package folds only when B * d_inner is a
multiple of 128 (TPU lane padding) and otherwise warns and takes its XLA
route, which computes the same function; the port runs the folded kernels
at every batch. The JAX package's other scan routes (``hwbc_folded``, the
sharded ones) are not ported. Parameter names follow the upstream torch
checkpoints (``in_proj``, ``conv2d``, ``x_proj_weight``,
``dt_projs_weight``, ``dt_projs_bias``, ``A_logs``, ``Ds``, ``out_norm``,
``out_proj``).
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
from mamba_unet_torch.ops.selective_scan_folded import (
    selective_scan_folded_bidir,
)
from mamba_unet_torch.ops.selective_scan_grouped import selective_scan_grouped

K = 4  # scan directions: [row, col, row-reversed, col-reversed]
# Fixed hyper-parameters of the Mamba-UNet SS2D (the JAX module's defaults,
# which no caller overrides): inner width = 2 * d_model, 3x3 depthwise conv
# with bias, no bias on the projections, dt_rank = ceil(d_model / 16),
# softplus(dt bias) ~ LogUniform(DT_MIN, DT_MAX) floored at DT_INIT_FLOOR.
EXPAND, D_CONV = 2, 3
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4
# scan_impl values of the JAX SS2D that the port runs: the bidirectional
# branch, the time-major one (which the xla route names too) and the
# batch-folded one; and those it does not run, with why
BIDIR_IMPLS, TM_IMPLS = ("auto", "bidir"), ("tm", "pallas", "xla")
FOLDED_IMPLS = ("folded",)
PORTED_IMPLS = BIDIR_IMPLS + TM_IMPLS + FOLDED_IMPLS
_PARALLELISM = ("it waits for the parallelism item (ROADMAP.md, queue 1, "
                "item 17)")
NOT_PORTED = {"hwbc_folded": "the hwbc layout is TPU-only machinery (its "
                             "time-major batch-minor maps make the folded "
                             "scan's stream setup a free reshape on the TPU) "
                             "and is not ported; use scan_impl='folded'",
              "seq_sharded": _PARALLELISM, "tp_sharded": _PARALLELISM}


def check_scan_impl(scan_impl: str) -> None:
    """Raise unless SS2D runs ``scan_impl``: ``NotImplementedError`` for a
    route of the JAX SS2D that is not ported, ``ValueError`` for any other
    value."""
    ported = ", ".join(PORTED_IMPLS)
    if scan_impl in NOT_PORTED:
        raise NotImplementedError(
            f"SS2D scan_impl={scan_impl!r} is not ported: "
            f"{NOT_PORTED[scan_impl]} (ported: {ported})")
    if scan_impl not in PORTED_IMPLS:
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
        elif self.scan_impl in FOLDED_IMPLS:
            y = self._scan_folded(xx)
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

    def _scan_folded(self, xx: torch.Tensor) -> torch.Tensor:
        """(B, H, W, d_inner) -> fp32 (B, H, W, d_inner): the two data
        streams time-major with the batch folded into the lanes, scanned
        both ways by the folded kernel; the JAX branch's projections as it
        writes them."""
        bsz, H, W, d = xx.shape
        L, R, n = H * W, self.dt_rank, self.d_state
        row = xx.permute(1, 2, 0, 3).reshape(L, bsz, d)
        col = xx.permute(2, 1, 0, 3).reshape(L, bsz, d)
        xs2 = torch.stack([row, col])                          # (2, L, B, d)
        # direction k = 2*j + m reads stream m: W[k] regroups as (j, m, ., .)
        Wg = self.x_proj_weight.float().reshape(2, 2, R + 2 * n, d)
        with torch.autocast(xx.device.type, enabled=False):
            M_dt = torch.einsum(  # one (d, d) dt matrix per direction, fp32
                "jmdr,jmre->jmde",
                self.dt_projs_weight.float().reshape(2, 2, d, R), Wg[:, :, :R])
        M_dt = M_dt.to(xs2.dtype)
        W_B = Wg[:, :, R:R + n].to(xs2.dtype)
        W_C = Wg[:, :, R + n:].to(xs2.dtype)
        dts = torch.einsum("mlbe,jmde->jmlbd", xs2, M_dt).reshape(
            K, L, bsz * d)
        Bs = torch.einsum("mlbd,jmnd->jmlnb", xs2, W_B).reshape(K, L, n, bsz)
        Cs = torch.einsum("mlbd,jmnd->jmlnb", xs2, W_C).reshape(K, L, n, bsz)
        ys = selective_scan_folded_bidir(
            xs2.reshape(2, L, bsz * d), dts, -torch.exp(self.A_logs.float()),
            Bs, Cs, self.Ds.float(), self.dt_projs_bias.float().reshape(-1),
        )                                                      # (4, L, B*d)
        # [row + row-rev, col + col-rev], added in fp32 as JAX widens first;
        # a sum and an unbind, whose backwards write no zero-filled slabs
        row, col = ys.reshape(2, 2, L, bsz, d).sum(
            0, dtype=torch.float32).unbind()
        return row.reshape(H, W, bsz, d).permute(2, 0, 1, 3) + col.reshape(
            W, H, bsz, d).permute(2, 1, 0, 3)
