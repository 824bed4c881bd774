"""Calibration curves on tensors (gridpp_tpu/ops/curves.py; reference
src/api/curve.cpp, metric_optimizer.cpp).

apply_curve interpolates along a curve with the reference's five
extrapolation policies, batched over cells: a shared 1-D curve by binary
search, per-cell curves (the gridded variant, curve.cpp:105-133) on a
trailing curve axis by broadcast counting. Torch ops on whatever device
the tensors lie, as they are XLA ops in gridpp_tpu, not a kernel port.
"""
from __future__ import annotations

import torch

from ..constants import Extrapolation, Metric

__all__ = ["piecewise_interp", "apply_curve", "calc_score", "contingency"]


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, i[..., None])[..., 0]


def piecewise_interp(x: torch.Tensor, xp: torch.Tensor,
                     fp: torch.Tensor) -> torch.Tensor:
    """gridpp's interpolate (util.cpp:377-432) with shared or per-cell
    curves.

    x: (...); xp, fp: (C,) or (..., C), sorted along the last axis and
    broadcastable to x's shape. Outside the curve the edge value is used;
    a repeated x (a flat interval) follows the reference's averaging
    rules; NaN in, NaN out."""
    c = xp.shape[-1]
    if xp.dim() == 1:
        # a shared curve: binary search, O(N log C)
        x = x.contiguous()
        left = torch.searchsorted(xp, x, side="left")
        right = torch.searchsorted(xp, x, side="right")
    else:
        # per-cell curves (small C): broadcast counting
        xp = xp.expand(x.shape + (c,))
        fp = fp.expand(x.shape + (c,))
        xb = x[..., None]
        left = torch.sum(xp < xb, dim=-1)
        right = torch.sum(xp <= xb, dim=-1)
    has_exact = right > left
    i0 = torch.where(has_exact, left, left - 1)
    i1 = torch.where(has_exact, right - 1, right)
    i0c = torch.clamp(i0, 0, c - 1)
    i1c = torch.clamp(i1, 0, c - 1)
    if xp.dim() == 1:
        x0, x1, y0, y1 = xp[i0c], xp[i1c], fp[i0c], fp[i1c]
    else:
        x0, x1, y0, y1 = (_take(xp, i0c), _take(xp, i1c), _take(fp, i0c),
                          _take(fp, i1c))
    first_x, last_x = xp[..., 0], xp[..., c - 1]
    first_y, last_y = fp[..., 0], fp[..., c - 1]
    flat = x0 == x1
    both_edge = (i0 == 0) & (i1 == c - 1)
    mid = (y0 + y1) / 2
    y_flat = torch.where(both_edge, mid,
                         torch.where(i0 == 0, y1,
                                     torch.where(i1 == c - 1, y0, mid)))
    dx = torch.where(flat, 1.0, x1 - x0)
    y_lin = y0 + (y1 - y0) * (x - x0) / dx
    y = torch.where(flat, y_flat, y_lin)
    y = torch.where(x > last_x, last_y, y)
    y = torch.where(x < first_x, first_y, y)
    return torch.where(torch.isfinite(x), y, torch.nan)


def apply_curve(fcst: torch.Tensor, curve_ref: torch.Tensor,
                curve_fcst: torch.Tensor, policy_below: int,
                policy_above: int) -> torch.Tensor:
    """apply_curve (curve.cpp:6-133), over every cell.

    fcst: (...); curve_ref, curve_fcst: (C,) or (..., C), curve_fcst
    sorted. Below and above the curve, the policy's line through the
    curve's end point."""
    c = curve_fcst.shape[-1]
    lo_f = curve_fcst[..., 0]
    hi_f = curve_fcst[..., c - 1]
    lo_r = curve_ref[..., 0]
    hi_r = curve_ref[..., c - 1]
    interp = piecewise_interp(fcst, curve_fcst, curve_ref)

    def extrap(policy, nearest_r, nearest_f, d_r, d_f):
        policy = int(policy)
        if policy == Extrapolation.Unchanged:
            return fcst
        if policy == Extrapolation.Zero:
            slope = torch.zeros_like(fcst)
        elif policy == Extrapolation.OneToOne or c <= 1:
            slope = torch.ones_like(fcst)
        elif policy == Extrapolation.MeanSlope:
            slope = (hi_r - lo_r) / (hi_f - lo_f)
        elif policy == Extrapolation.NearestSlope:
            slope = d_r / d_f
        else:
            raise ValueError("Unknown extrapolation policy")
        return nearest_r + slope * (fcst - nearest_f)

    if c >= 2:
        below_d_r = curve_ref[..., 1] - curve_ref[..., 0]
        below_d_f = curve_fcst[..., 1] - curve_fcst[..., 0]
        above_d_r = curve_ref[..., c - 1] - curve_ref[..., c - 2]
        above_d_f = curve_fcst[..., c - 1] - curve_fcst[..., c - 2]
    else:
        below_d_r = below_d_f = above_d_r = above_d_f = torch.ones_like(lo_r)
    below = extrap(policy_below, lo_r, lo_f, below_d_r, below_d_f)
    above = extrap(policy_above, hi_r, hi_f, above_d_r, above_d_f)
    return torch.where(fcst < lo_f, below,
                       torch.where(fcst > hi_f, above, interp))


def calc_score(a, b, c, d, metric: int) -> torch.Tensor:
    """Contingency-table score (metric_optimizer.cpp:207-244) in f32, on
    the device of a when it is a tensor, else on the CPU."""
    dev = a.device if isinstance(a, torch.Tensor) else "cpu"
    a, b, c, d = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                  for v in (a, b, c, d))
    metric = int(metric)
    if metric == Metric.Ets:
        n = a + b + c + d
        ar = (a + b) / n * (a + c)
        denom = a + b + c - ar
        return torch.where(denom == 0, torch.nan, (a - ar) / denom)
    if metric == Metric.Ts:
        return a / (a + b + c)
    if metric == Metric.Pc:
        return (a + d) / (a + b + c + d)
    if metric == Metric.Kss:
        denom = (a + c) * (b + d)
        return torch.where(denom == 0, torch.nan, (a * d - b * c) / denom)
    if metric == Metric.Bias:
        return torch.where(b == c, 1.0, 1 - torch.abs(b - c) / (b + c))
    if metric == Metric.Hss:
        denom = (a + c) * (c + d) + (a + b) * (b + d)
        return torch.where(denom == 0, torch.nan,
                           2.0 * (a * d - b * c) / denom)
    raise ValueError("Unknown metric")


def contingency(ref: torch.Tensor, fcst: torch.Tensor, threshold,
                fthreshold):
    """The a, b, c, d counts (metric_optimizer.cpp:189-206); a missing ref
    counts in neither class."""
    fpos = fcst > fthreshold
    rpos = ref > threshold
    rneg = ref <= threshold
    a = torch.sum(fpos & rpos)
    b = torch.sum(fpos & rneg)
    c = torch.sum(~fpos & rpos)
    d = torch.sum(~fpos & rneg)
    return a, b, c, d
