"""Neighbourhood (moving-window) statistics on tensors.

The counterpart of gridpp_tpu/ops/neighbourhood.py, with its semantics:
non-finite values are missing, windows are clipped at the domain edge, and a
halfwidth beyond the grid is clipped per axis.

- Mean/Sum/Count, Min/Max and Std/Variance (`neighbourhood`, h > 0): a CUDA
  tensor goes through kernel K1, K2 or K3 (ops/stencil.py) at any
  halfwidth (its one-block kernel, or past that its wide route, as
  stencil.stencil_plan picks), a CPU tensor through the kernel's plain
  version. `_xla_basic` is the plain dispatch.
- Every other statistic (Median, Quantile, ...) takes the brute-force path:
  the (2h+1)^2 shifted copies of the field and an exact reduction, in plain
  PyTorch on whatever device the tensor lies (XLA in the reference, so not a
  kernel port).
- `neighbourhood_quantile_fast`: a 2-D input with a scalar quantile goes
  through kernel K4 on the card; the (Y, X, E) input and a per-cell
  quantile take `_quantile_fast_xla`, which smooths the (T, Y, X) stack of
  threshold indicator planes with `neighbourhood` (K1 on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import Statistic
from . import stencil
from .stats import nan_quantile, nan_statistic

__all__ = [
    "window_sum", "window_count", "window_min", "window_max",
    "neighbourhood", "neighbourhood_brute_force", "neighbourhood_quantile",
    "neighbourhood_quantile_fast", "interp_quantile_from_cdf",
]

_STENCIL_STATS = stencil.MEAN_STATS + stencil.MINMAX_STATS + stencil.VAR_STATS


def _clipped(x, h: int):
    return min(h, x.shape[-2] - 1), min(h, x.shape[-1] - 1)


def _planes(x):
    """x as (B, Y, X) for the stencils, which take (Y, X) or (B, Y, X)."""
    return x if x.dim() <= 3 else x.reshape((-1,) + x.shape[-2:])


def window_sum(x: torch.Tensor, h: int) -> torch.Tensor:
    """NaN-skipping moving-window sum (invalid cells contribute 0)."""
    return neighbourhood(torch.where(torch.isfinite(x), x, 0.0), h,
                         Statistic.Sum)


def window_count(x: torch.Tensor, h: int) -> torch.Tensor:
    """Moving-window count of valid cells."""
    return neighbourhood(x, h, Statistic.Count)


def window_min(x: torch.Tensor, h: int) -> torch.Tensor:
    return neighbourhood(x, h, Statistic.Min)


def window_max(x: torch.Tensor, h: int) -> torch.Tensor:
    return neighbourhood(x, h, Statistic.Max)


def neighbourhood(input: torch.Tensor, halfwidth: int,
                  statistic: int) -> torch.Tensor:
    """Moving-window statistic over the last two axes (Y, X) of an f32
    tensor; leading axes are independent planes (neighbourhood.cpp:28-241
    dispatch)."""
    statistic = int(statistic)
    h = int(halfwidth)
    if h < 0:
        raise ValueError("halfwidth must be >= 0")
    x = input.to(torch.float32)
    if statistic not in _STENCIL_STATS:
        return neighbourhood_brute_force(x, h, statistic)
    if h == 0:
        return stencil.single_cell(x, statistic)
    hy, hx = _clipped(x, h)
    if x.is_cuda:
        planes = _planes(x).contiguous()
        if statistic in stencil.MEAN_STATS:
            out = stencil.neighbourhood_mean_cuda(planes, hy, hx, statistic)
        elif statistic in stencil.MINMAX_STATS:
            out = stencil.neighbourhood_minmax_cuda(planes, hy, hx,
                                                    statistic)
        else:
            out = stencil.neighbourhood_var_cuda(planes, hy, hx, statistic)
        return out.reshape(x.shape)
    if x.device.type != "cpu":
        raise ValueError(f"no neighbourhood kernel for device {x.device}")
    return _xla_basic(x, h, statistic)


def _xla_basic(input: torch.Tensor, h: int, statistic: int) -> torch.Tensor:
    """The plain dispatch (every statistic): the kernels' plain versions
    for the stencil statistics, else the brute force."""
    statistic = int(statistic)
    if statistic not in _STENCIL_STATS:
        return neighbourhood_brute_force(input, h, statistic)
    x = input.to(torch.float32)
    hy, hx = _clipped(x, h)
    planes = _planes(x)
    if statistic in stencil.MEAN_STATS:
        out = stencil.neighbourhood_mean_plain(planes, hy, hx, statistic)
    elif statistic in stencil.MINMAX_STATS:
        out = stencil.neighbourhood_minmax_plain(planes, hy, hx, statistic)
    else:
        out = stencil.neighbourhood_var_plain(planes, hy, hx, statistic)
    return out.reshape(x.shape)


def _window_stack(x: torch.Tensor, h: int,
                  rows: slice | None = None) -> torch.Tensor:
    """The (2h+1)^2 shifted copies of x along a new last axis, in (dy, dx)
    order; out-of-domain positions are NaN (skipped by the NaN-aware
    reductions), which gives the clipped window. h is clamped to the grid
    extent: larger windows are equivalent after edge clipping. rows: only
    these rows' windows are made."""
    h = min(h, max(x.shape[-2], x.shape[-1]) - 1)
    w = 2 * h + 1
    xp = F.pad(x.to(torch.float32), (h, h, h, h), value=torch.nan)
    stack = xp.unfold(-2, w, 1).unfold(-2, w, 1)  # (..., Y, X, w_y, w_x)
    if rows is not None:
        stack = stack[..., rows, :, :, :]
    return stack.reshape(stack.shape[:-2] + (w * w,))


def neighbourhood_brute_force(input: torch.Tensor, halfwidth: int,
                              statistic: int) -> torch.Tensor:
    """Windowed gather + exact statistic (neighbourhood.cpp:556-654)."""
    stack = _window_stack(input, int(halfwidth))
    return nan_statistic(stack, int(statistic), axis=-1)


def neighbourhood_quantile(input: torch.Tensor, quantile,
                           halfwidth: int) -> torch.Tensor:
    """Exact windowed quantile via per-cell sorted order statistics."""
    stack = _window_stack(input, int(halfwidth))
    return nan_quantile(stack, quantile, axis=-1)


def _ens_window_stack(input: torch.Tensor, h: int) -> torch.Tensor:
    """(Y, X, E) -> (Y, X, E * W): each cell's window over every member."""
    stack = _window_stack(torch.movedim(input, -1, 0), h)  # (E, Y, X, W)
    stack = torch.movedim(stack, 0, -2)                    # (Y, X, E, W)
    return stack.reshape(stack.shape[:-2] + (-1,))


def neighbourhood_quantile_ens(input: torch.Tensor, quantile,
                               halfwidth: int) -> torch.Tensor:
    """(Y, X, E) variant: the window gathers across the members too."""
    return nan_quantile(_ens_window_stack(input, int(halfwidth)), quantile,
                        axis=-1)


def neighbourhood_brute_force_ens(input: torch.Tensor, halfwidth: int,
                                  statistic: int) -> torch.Tensor:
    return nan_statistic(_ens_window_stack(input, int(halfwidth)),
                         int(statistic), axis=-1)


def interp_quantile_from_cdf(q, cdf: torch.Tensor,
                             thresholds: torch.Tensor) -> torch.Tensor:
    """Per-cell piecewise-linear inverse CDF (neighbourhood.cpp:367-404).

    cdf: (Y, X, T), non-decreasing along T (NaN = missing); thresholds:
    (T,); q: scalar or (Y, X)."""
    return _interp_quantile_tyx(q, torch.movedim(cdf, -1, 0), thresholds)


def _interp_quantile_tyx(q, cdf: torch.Tensor,
                         thresholds: torch.Tensor) -> torch.Tensor:
    """Inverse CDF with cdf in (T, Y, X) layout: gridpp::interpolate's
    flat-interval rules plus the two exact-edge cases. Kernel K4 computes
    the same expressions in the same order."""
    t = thresholds.shape[0]
    thr = torch.as_tensor(thresholds, dtype=cdf.dtype, device=cdf.device)
    q = torch.as_tensor(q, dtype=cdf.dtype, device=cdf.device)
    qs = torch.broadcast_to(q, cdf.shape[1:])             # (Y, X)
    left = torch.sum(cdf < qs[None], dim=0)    # first index with cdf >= q
    right = torch.sum(cdf <= qs[None], dim=0)  # first index with cdf > q
    has_exact = right > left
    i0 = torch.where(has_exact, left, left - 1)
    i1 = torch.where(has_exact, right - 1, right)
    i0c = torch.clamp(i0, 0, t - 1)
    i1c = torch.clamp(i1, 0, t - 1)
    x0 = torch.gather(cdf, 0, i0c[None])[0]
    x1 = torch.gather(cdf, 0, i1c[None])[0]
    y0 = thr[i0c]
    y1 = thr[i1c]
    flat = x0 == x1
    both_edge = (i0 == 0) & (i1 == t - 1)
    mid = (y0 + y1) / 2
    y_flat = torch.where(both_edge, mid,
                         torch.where(i0 == 0, y1,
                                     torch.where(i1 == t - 1, y0, mid)))
    dx = torch.where(flat, 1.0, x1 - x0)
    y_lin = y0 + (y1 - y0) * (qs - x0) / dx
    y = torch.where(flat, y_flat, y_lin)
    y = torch.where(qs > cdf[t - 1], thr[t - 1], y)
    y = torch.where(qs < cdf[0], thr[0], y)
    # exact-edge special cases (neighbourhood.cpp:396-401)
    y = torch.where((qs == 1) & (cdf[0] == 1), thr[0], y)
    y = torch.where((qs == 0) & (cdf[t - 1] == 0), thr[t - 1], y)
    missing = torch.any(~torch.isfinite(cdf), dim=0) | ~torch.isfinite(qs)
    return torch.where(missing, torch.nan, y)


def neighbourhood_quantile_fast(input: torch.Tensor, quantile,
                                halfwidth: int,
                                thresholds: torch.Tensor) -> torch.Tensor:
    """Threshold-CDF approximate windowed quantile (neighbourhood.cpp:
    302-409). input: (Y, X) or (Y, X, E); quantile: a scalar or (Y, X);
    thresholds: (T,). For each threshold, the fraction of valid values
    <= threshold is smoothed with the Mean stencil; the quantile is read
    off by per-cell interpolation across thresholds."""
    x = input.to(torch.float32)
    h = int(halfwidth)
    if h < 0:
        raise ValueError("halfwidth must be >= 0")
    thr = torch.as_tensor(thresholds, dtype=torch.float32, device=x.device)
    if x.dim() == 2 and torch.as_tensor(quantile).dim() == 0 and x.is_cuda:
        hy, hx = _clipped(x, h)
        return stencil.neighbourhood_quantile_fast_cuda(
            x.contiguous(), quantile, hy, hx, thr)
    return _quantile_fast_xla(x, quantile, h, thr)


def _quantile_fast_xla(input: torch.Tensor, quantile, halfwidth: int,
                       thresholds: torch.Tensor) -> torch.Tensor:
    """The threshold-CDF path of every input form; K4's plain version."""
    ens = input.dim() == 3
    t = thresholds.shape[0]
    thr = torch.as_tensor(thresholds, dtype=torch.float32,
                          device=input.device)
    valid = torch.isfinite(input)
    # (T, Y, X[, E]) indicators
    le = input[None] <= thr.reshape((t,) + (1,) * input.dim())
    if ens:
        num = torch.sum(le & valid[None], dim=-1).to(torch.float32)
        den = torch.sum(valid, dim=-1)[None].to(torch.float32)
        temp = torch.where(den > 0, num / torch.clamp(den, min=1.0),
                           torch.nan)
    else:
        temp = torch.where(valid[None], le.to(torch.float32), torch.nan)
    stats = neighbourhood(temp, int(halfwidth), Statistic.Mean)  # (T, Y, X)
    cdf = torch.where(torch.isfinite(stats), torch.clamp(stats, 0.0, 1.0),
                      torch.nan)
    return _interp_quantile_tyx(quantile, cdf, thr)
