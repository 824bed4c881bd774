"""Running-window statistics along the last axis (time series) on tensors
(gridpp_tpu/ops/window.py; reference src/api/window.cpp).

Mean, Sum and Count come from running sums (one cumsum pass, every row
batched); every other statistic from the gathered (..., X, W) window stack
through the NaN-aware reductions of ops/stats.py. Flags as the reference's:
`before` (a trailing window), `keep_missing` (a window with a missing value
gives NaN), `missing_edges` (a window cut by the series' edge gives NaN).
Torch ops on whatever device the tensor lies, as they are XLA ops in
gridpp_tpu, not a kernel port.
"""
from __future__ import annotations

import torch

from ..constants import Statistic
from .stats import nan_statistic

__all__ = ["window"]


def _start_end(x_idx, length: int, before: bool, nx: int):
    if before:
        return torch.clamp(x_idx - length + 1, min=0), x_idx
    return (torch.clamp(x_idx - length // 2, min=0),
            torch.clamp(x_idx + length // 2, max=nx - 1))


def window(array: torch.Tensor, length: int, statistic: int, before: bool,
           keep_missing: bool, missing_edges: bool) -> torch.Tensor:
    """array: (..., X) f32. Returns the same shape (window.cpp:6-156)."""
    statistic = int(statistic)
    nx = array.shape[-1]
    x_idx = torch.arange(nx, device=array.device)
    start, end = _start_end(x_idx, length, before, nx)

    valid = torch.isfinite(array)
    if statistic in (Statistic.Mean, Statistic.Sum, Statistic.Count):
        csum = torch.cumsum(torch.where(valid, array, 0.0), dim=-1)
        ccnt = torch.cumsum(valid.to(torch.float32), dim=-1)
        prev = torch.clamp(start - 1, min=0)
        wsum = csum[..., end] - torch.where(start > 0, csum[..., prev], 0.0)
        wcnt = ccnt[..., end] - torch.where(start > 0, ccnt[..., prev], 0.0)
        if statistic == Statistic.Count:
            return wcnt
        out = torch.where(wcnt != 0,
                          wsum / wcnt if statistic == Statistic.Mean
                          else wsum, torch.nan)
        if keep_missing:
            full = (end - (start - 1)).to(torch.float32)
            out = torch.where(wcnt < full, torch.nan, out)
        if missing_edges:
            if before:
                edge = x_idx < length - 1
            else:
                edge = (x_idx < length // 2) | (x_idx + length // 2 + 1 > nx)
            out = torch.where(edge, torch.nan, out)
        return out

    # the window stacked along a new last axis by one gather
    if before:
        offsets = torch.arange(-length + 1, 1, device=array.device)
    else:
        offsets = torch.arange(-(length // 2), length // 2 + 1,
                               device=array.device)
    idx = x_idx[:, None] + offsets[None, :]
    in_range = (idx >= 0) & (idx < nx)
    idx_c = torch.clamp(idx, 0, nx - 1)
    stack = torch.where(in_range, array[..., idx_c], torch.nan)
    # the missing values among the in-range elements only
    missing = torch.sum(in_range & ~valid[..., idx_c], dim=-1)
    out = nan_statistic(stack, statistic, axis=-1)
    if keep_missing:
        out = torch.where(missing > 0, torch.nan, out)
    if missing_edges:
        if before:
            outside = x_idx - length + 1 < 0
        else:
            outside = ((x_idx - length // 2 < 0)
                       | (x_idx + length // 2 > nx - 1))
        out = torch.where(outside, torch.nan, out)
    return out
