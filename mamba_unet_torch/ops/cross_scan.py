"""4-direction cross-scan / cross-merge for SS2D, time-major.

Port of ``mamba_unet_tpu/ops/cross_scan.py`` (``cross_scan_tm`` /
``cross_merge_tm``). Feature maps are channels-last (B, H, W, D); scan
sequences are time-major (B, K, L, D) with L = H * W. The direction order is
[row, col, row-reversed, col-reversed]: the column stream is the map with H
and W swapped, so its time index is t = w * H + h.

SS2D's bidirectional scan reads only the two data streams
(:func:`row_col_streams`) and returns their pair-summed outputs, which
:func:`merge_row_col` maps back onto the feature map.
"""

from __future__ import annotations

import torch


def row_col_streams(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B, 2, L, D): [row-major, column-major] streams."""
    bsz, H, W, d = x.shape
    row = x.reshape(bsz, H * W, d)
    col = x.transpose(1, 2).reshape(bsz, H * W, d)
    return torch.stack([row, col], dim=1)


def merge_row_col(y2: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`row_col_streams` + sum: (B, 2, L, D) -> (B, H, W, D)."""
    bsz, _, _, d = y2.shape
    return y2[:, 0].reshape(bsz, H, W, d) + y2[:, 1].reshape(
        bsz, W, H, d).transpose(1, 2)


def cross_scan_tm(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B, 4, L, D): [row, col, row-rev, col-rev]."""
    fwd = row_col_streams(x)
    return torch.cat([fwd, fwd.flip(2)], dim=1)


def cross_merge_tm(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`cross_scan_tm` + sum: (B, 4, L, D) -> (B, H, W, D)."""
    if ys.shape[1] != 4 or ys.shape[2] != H * W:
        raise ValueError(f"expected (B, 4, {H * W}, D), got {tuple(ys.shape)}")
    return merge_row_col(ys[:, :2] + ys[:, 2:].flip(2), H, W)
