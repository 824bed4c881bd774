"""NaN-aware statistical reductions on tensors.

The counterpart of gridpp_tpu/ops/stats.py (reference src/api/util.cpp:
19-216, calc_statistic and calc_quantile): missing values are non-finite,
reductions skip them, and quantiles interpolate between order statistics
as the reference's sort-based implementation does. Every function reduces
the LAST axis (or `axis`) and broadcasts over the leading ones.
"""
from __future__ import annotations

import torch

from ..constants import Statistic

__all__ = ["is_valid", "valid_count", "nan_quantile", "nan_statistic",
           "variance_ddof0", "interpolate"]


def is_valid(x: torch.Tensor) -> torch.Tensor:
    """Elementwise validity mask (reference util.cpp:16-18): finite values."""
    return torch.isfinite(x)


def valid_count(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.sum(is_valid(x), dim=axis)


def nan_quantile(x: torch.Tensor, q, axis: int = -1) -> torch.Tensor:
    """Quantile of the valid values, interpolating between order statistics
    (util.cpp:111-178): sort, take the order statistics at floor and ceil
    of q * (N - 1), interpolate. All-invalid rows and a non-finite q give
    NaN. q is a scalar or a tensor broadcastable against x without its
    reduction axis (per-cell levels, gridpp.h:1480)."""
    x = torch.movedim(x, axis, -1)
    t = x.shape[-1]
    if t == 0:
        return torch.full(x.shape[:-1], torch.nan, dtype=x.dtype,
                          device=x.device)
    s = torch.sort(x, dim=-1).values  # NaN sorts last, as in jnp.sort
    n = torch.sum(torch.isfinite(x), dim=-1)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    qn = q * (n - 1).to(x.dtype)
    lo = torch.clamp(torch.floor(qn).to(torch.int64), 0, t - 1)
    hi = torch.clamp(torch.ceil(qn).to(torch.int64), 0, t - 1)
    shape = torch.broadcast_shapes(lo.shape, s.shape[:-1])
    s = s.expand(shape + (t,))
    lv = torch.gather(s, -1, lo.expand(shape)[..., None])[..., 0]
    uv = torch.gather(s, -1, hi.expand(shape)[..., None])[..., 0]
    denom = (hi - lo).to(x.dtype)
    f = torch.where(denom > 0,
                    (qn - lo.to(x.dtype)) / torch.where(denom > 0, denom, 1.0),
                    0.0)
    val = lv + (uv - lv) * f
    return torch.where((n > 0) & torch.isfinite(q), val, torch.nan)


def _masked_sum_count(x, axis=-1):
    m = torch.isfinite(x)
    return torch.sum(torch.where(m, x, 0.0), dim=axis), torch.sum(m, dim=axis)


def variance_ddof0(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Population variance with the reference's K shift (util.cpp:38-73):
    var(X - K) with K the first valid element, E[Y^2] - E[Y]^2, clamped at
    0; NaN where no value is valid."""
    x = torch.movedim(x, axis, -1)
    m = torch.isfinite(x)
    first = torch.argmax(m.to(torch.uint8), dim=-1, keepdim=True)
    k = torch.gather(x, -1, first)
    y = torch.where(m, x - k, 0.0)
    count = torch.sum(m, dim=-1)
    cnt = torch.clamp(count, min=1).to(x.dtype)
    mean = torch.sum(y, dim=-1) / cnt
    mean2 = torch.sum(y * y, dim=-1) / cnt
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return torch.where(count > 0, var, torch.nan)


def nan_statistic(x: torch.Tensor, statistic: int, axis: int = -1,
                  quantile=None) -> torch.Tensor:
    """Reduce `axis` with a gridpp Statistic, skipping NaN (util.cpp:
    19-110). Statistic.Quantile needs `quantile`; RandomChoice is left to
    the API layer (it needs a host random state) and raises here."""
    statistic = int(statistic)
    if statistic in (Statistic.Mean, Statistic.Sum, Statistic.Count):
        total, count = _masked_sum_count(x, axis=axis)
        if statistic == Statistic.Count:
            return count.to(x.dtype)
        val = (total / torch.clamp(count, min=1)
               if statistic == Statistic.Mean else total)
        return torch.where(count > 0, val, torch.nan)
    if statistic in (Statistic.Std, Statistic.Variance):
        var = variance_ddof0(x, axis=axis)
        return torch.sqrt(var) if statistic == Statistic.Std else var
    if statistic == Statistic.Min:
        return nan_quantile(x, 0.0, axis=axis)
    if statistic == Statistic.Median:
        return nan_quantile(x, 0.5, axis=axis)
    if statistic == Statistic.Max:
        return nan_quantile(x, 1.0, axis=axis)
    if statistic == Statistic.Quantile:
        if quantile is None:
            raise ValueError("Statistic.Quantile requires a quantile level")
        return nan_quantile(x, quantile, axis=axis)
    raise ValueError(f"Cannot compute statistic {statistic}")


def interpolate(x: torch.Tensor, xp: torch.Tensor,
                fp: torch.Tensor) -> torch.Tensor:
    """gridpp's piecewise-linear interpolation (util.cpp:377-432).

    xp must be sorted. Outside [xp[0], xp[-1]] the edge fp value is used.
    At a repeated x value (a flat interval) the mean of the interval's two
    end values is used, unless the interval touches exactly one end of the
    curve, where the inner end's value is used. x: any shape; xp, fp: 1-D,
    on x's device."""
    n = xp.shape[0]
    if n == 0:
        return torch.full(x.shape, torch.nan, dtype=torch.float32,
                          device=x.device)
    x = x.contiguous()
    left = torch.searchsorted(xp, x, side="left")
    right = torch.searchsorted(xp, x, side="right")
    has_exact = right > left
    i0 = torch.where(has_exact, left, left - 1)   # first == x, else last < x
    i1 = torch.where(has_exact, right - 1, right)  # last == x, else first > x
    i0c = torch.clamp(i0, 0, n - 1)
    i1c = torch.clamp(i1, 0, n - 1)
    x0 = xp[i0c]
    x1 = xp[i1c]
    y0 = fp[i0c]
    y1 = fp[i1c]
    flat = x0 == x1
    both_edge = (i0 == 0) & (i1 == n - 1)
    mid = (y0 + y1) / 2
    y_flat = torch.where(both_edge, mid,
                         torch.where(i0 == 0, y1,
                                     torch.where(i1 == n - 1, y0, mid)))
    dx = torch.where(flat, 1.0, x1 - x0)
    y_lin = y0 + (y1 - y0) * (x - x0) / dx
    y = torch.where(flat, y_flat, y_lin)
    y = torch.where(x > xp[n - 1], fp[n - 1], y)
    y = torch.where(x < xp[0], fp[0], y)
    return torch.where(torch.isfinite(x), y, torch.nan)
