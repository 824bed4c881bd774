"""Gradient-based downscaling and per-cell gradient estimation
(gridpp_tpu/api/gradients.py; reference src/api/{simple_gradient,gradient,
calc_gradient}.cpp).

numpy in, numpy out. The route follows the API's device, read once per
call (api/_common.api_device). The downscalers and corrections run as tensors
on that device and are copied to the host once, at the end. calc_gradient's
LinearRegression takes the native fused solver on the host (sums in
double, csrc calc_gradient_lr), and on a device four windowed Means and one
windowed Sum through ops.neighbourhood, which are five K1 launches on the
card. MinMax is a chunked window stack on either.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..constants import MV, Downscaler, GradientType, Statistic
from ..ops import neighbourhood as nops
from ._common import (api_device, asarray_f32, check_grid_compatible,
                      on_host, upload)
from .downscaling import downscale_tensor, downscaling

__all__ = ["simple_gradient", "full_gradient", "full_gradient_debug",
           "calc_gradient"]

# window-stack elements per MinMax chunk (rows x X x window), as gridpp_tpu
_MINMAX_CHUNK = 2e7


def simple_gradient(igrid, target, ivalues, elev_gradient,
                    downscaler=Downscaler.Nearest):
    """Downscale, then correct by one elevation gradient
    (simple_gradient.cpp)."""
    ivalues = asarray_f32(ivalues)
    check_grid_compatible(igrid, ivalues)
    dev = api_device()
    dvalues = downscale_tensor(igrid, target, upload(ivalues, dev),
                               downscaler)
    delevs = downscale_tensor(igrid, target, upload(igrid.get_elevs(), dev),
                              downscaler)
    oelevs = upload(np.asarray(target.get_elevs(), np.float32), dev)
    corr = (oelevs - delevs) * float(elev_gradient)
    return (dvalues + corr).cpu().numpy()


def _gradient_fields(name, gradient, gy, gx, dev):
    """The (n, Y, X) tensor of a gradient field for the stacked call, or
    None when it is empty: n is 1 for a 2-D field, which then applies at
    every time (ROADMAP F10)."""
    if gradient is None or not np.size(gradient):
        return None
    gradient = asarray_f32(gradient, name)
    if gradient.shape[-2:] != (gy, gx):
        raise ValueError(
            {"elev_gradient": "Elevation gradient is the wrong size",
             "laf_gradient": "Laf gradient is the wrong size"}[name])
    return upload(gradient if gradient.ndim == 3 else gradient[None], dev)


def full_gradient(igrid, target, ivalues, elev_gradient, laf_gradient=None,
                  downscaler=Downscaler.Nearest):
    """Downscale with per-cell elevation and land-area-fraction gradient
    fields (gradient.cpp:5-130): the values, the gradients and the source
    elevations and lafs are downscaled in one stacked call, then corrected
    against the target's elevations and lafs. A 2-D gradient field applies
    at every time of 3-D values (gridpp_tpu takes its second copy for the
    downscaled elevations there: ROADMAP F10)."""
    ivalues = asarray_f32(ivalues)
    is3d = ivalues.ndim == 3
    gy, gx = igrid.size()
    if ivalues.shape[-2:] != (gy, gx):
        raise ValueError("Values is the wrong size")
    dev = api_device()
    vals3 = upload(ivalues if is3d else ivalues[None], dev)
    nt = vals3.shape[0]
    eg3 = _gradient_fields("elev_gradient", elev_gradient, gy, gx, dev)
    lg3 = _gradient_fields("laf_gradient", laf_gradient, gy, gx, dev)
    fields = [vals3]
    if eg3 is not None:
        fields += [eg3, upload(igrid.get_elevs()[None], dev)]
    if lg3 is not None:
        fields += [lg3, upload(igrid.get_lafs()[None], dev)]
    down = downscale_tensor(igrid, target, torch.cat(fields, dim=0),
                            downscaler)

    out = down[:nt]
    c = nt
    elev_corr = 0.0
    if eg3 is not None:
        n_eg = eg3.shape[0]
        deg = down[c:c + n_eg]
        delevs = down[c + n_eg]
        c += n_eg + 1
        oelevs = upload(np.asarray(target.get_elevs(), np.float32), dev)
        both = torch.isfinite(oelevs) & torch.isfinite(delevs)
        elev_corr = torch.where(both, deg * (oelevs - delevs), 0.0)
    laf_corr = 0.0
    if lg3 is not None:
        n_lg = lg3.shape[0]
        dlg = down[c:c + n_lg]
        dlafs = down[c + n_lg]
        olafs = upload(np.asarray(target.get_lafs(), np.float32), dev)
        both = torch.isfinite(olafs) & torch.isfinite(dlafs)
        laf_corr = torch.where(both, dlg * (olafs - dlafs), 0.0)
    out = out + laf_corr + elev_corr
    out = out.cpu().numpy()
    return out if is3d else out[0]


def full_gradient_debug(igrid, ogrid, ivalues, elev_gradient,
                        laf_gradient=None, downscaler=Downscaler.Nearest):
    """The stacked intermediate fields of full_gradient (gradient.cpp
    full_gradient_debug): [output, downscaled elevation gradient,
    downscaled source elevations]."""
    out = full_gradient(igrid, ogrid, ivalues, elev_gradient, laf_gradient,
                        downscaler)
    deg = downscaling(igrid, ogrid, asarray_f32(elev_gradient), downscaler)
    delevs = downscaling(igrid, ogrid, igrid.get_elevs(), downscaler)
    return np.stack([out, deg, delevs], axis=0)


def minmax_gradient(base: torch.Tensor, values: torch.Tensor, h: int,
                    min_num: int, min_range: float,
                    default_gradient: float) -> torch.Tensor:
    """Per-cell (v(max b) - v(min b)) / (max b - min b) over the (2h+1)^2
    window (calc_gradient.cpp:28-75), on the tensors' device; the first
    window position wins a tie, as the reference's scan does. base and
    values: (Y, X), NaN where either is missing. Rows are taken in chunks
    of _MINMAX_CHUNK window elements."""
    ny, nx = base.shape
    w2 = (2 * h + 1) ** 2
    chunk = max(1, int(_MINMAX_CHUNK / max(nx * w2, 1)))
    rows = []
    for s in range(0, ny, chunk):
        e = min(s + chunk, ny)
        lo = max(0, s - h)
        hi = min(ny, e + h)
        bstack = nops._window_stack(base[lo:hi], h)[s - lo:e - lo]
        vstack = nops._window_stack(values[lo:hi], h)[s - lo:e - lo]
        valid = torch.isfinite(bstack)
        count = torch.sum(valid, dim=-1)
        imax = torch.argmax(torch.where(valid, bstack, -torch.inf), dim=-1,
                            keepdim=True)
        imin = torch.argmin(torch.where(valid, bstack, torch.inf), dim=-1,
                            keepdim=True)
        bmax = torch.gather(bstack, -1, imax)[..., 0]
        bmin = torch.gather(bstack, -1, imin)[..., 0]
        vmax = torch.gather(vstack, -1, imax)[..., 0]
        vmin = torch.gather(vstack, -1, imin)[..., 0]
        grad = (vmax - vmin) / torch.where(bmax == bmin, 1.0, bmax - bmin)
        ok = (count >= min_num) & torch.isfinite(bmax) & torch.isfinite(bmin)
        if np.isfinite(min_range):
            ok = ok & (torch.abs(bmax - bmin) > min_range)
        else:
            ok = ok & (bmax != bmin)
        rows.append(torch.where(ok, grad, default_gradient))
    return torch.cat(rows, dim=0)


def lr_moments(base: torch.Tensor, values: torch.Tensor, h: int):
    """The windowed moments of the regression of values on base over the
    (2h+1)^2 window: the Means of x, y, x * x and x * y and the Sum of the
    valid cells (ops.neighbourhood: five K1 launches on the card, K1's
    plain version on the CPU), in f32. base and values: (Y, X), NaN where
    either is missing."""
    both = torch.isfinite(base) & torch.isfinite(values)
    return (nops.neighbourhood(base, h, Statistic.Mean),
            nops.neighbourhood(values, h, Statistic.Mean),
            nops.neighbourhood(base * base, h, Statistic.Mean),
            nops.neighbourhood(base * values, h, Statistic.Mean),
            nops.neighbourhood(both.to(torch.float32), h, Statistic.Sum))


def lr_gradient(base: torch.Tensor, values: torch.Tensor, h: int,
                min_num: int, min_range: float,
                default_gradient: float) -> torch.Tensor:
    """Per-cell least-squares slope of values against base over the
    (2h+1)^2 window (calc_gradient.cpp:76-124) from lr_moments, in f32:
    (E[xy] - E[x]E[y]) / (E[xx] - E[x]^2), as gridpp_tpu's fallback. Where a
    window's spread is small against its mean the variance cancels most of
    f32's digits (ROADMAP F9)."""
    mean_x, mean_y, mean_xx, mean_xy, count = lr_moments(base, values, h)
    var = mean_xx - mean_x * mean_x
    grad = (mean_xy - mean_x * mean_y) / torch.where(var == 0, 1.0, var)
    ok = ((count >= min_num) & torch.isfinite(mean_xx)
          & torch.isfinite(mean_xy) & torch.isfinite(mean_x) & (var != 0))
    if np.isfinite(min_range):
        rng = torch.sqrt(var)
        ok = ok & torch.isfinite(rng) & (rng >= min_range)
    return torch.where(ok, grad, default_gradient)


def lr_bar(moments, rtol, atol):
    """A tolerance for lr_gradient: how far the gradient (E[xy] - E[x]E[y])
    / (E[xx] - E[x]^2) of the five windowed `moments` (lr_moments) may move
    when each moment moves within (rtol, atol), per cell, and whether those
    bars fix the variance's sign at all (|var| above its own bar). Returns
    (bar, determined); bar is inf where they do not."""
    mx, my, mxx, mxy, _ = (np.asarray(m, np.float64) for m in moments)

    def err(m):
        return atol + rtol * np.abs(m)

    var = mxx - mx * mx
    cov = mxy - mx * my
    dvar = err(mxx) + 2 * np.abs(mx) * err(mx) + err(mx) ** 2
    dcov = (err(mxy) + np.abs(mx) * err(my) + np.abs(my) * err(mx)
            + err(mx) * err(my))
    determined = np.abs(var) > dvar
    safe = np.where(determined, np.abs(var) - dvar, 1.0)
    g = np.abs(cov) / np.where(determined, np.abs(var), 1.0)
    return np.where(determined, (dcov + g * dvar) / safe, np.inf), determined


def calc_gradient(base, values, gradient_type, halfwidth, min_num=2,
                  min_range=MV, default_gradient=0):
    """Per-cell gradient of values against base in a (2h+1)^2 window
    (calc_gradient.cpp:6-126)."""
    if halfwidth <= 0:
        raise ValueError(
            "Halwidth cannot be <= 0; must be positive integer")
    if np.isfinite(min_range) and min_range < 0:
        raise ValueError("min_range must be >= 0")
    if min_num < 0:
        raise ValueError("num_min must be >= 0")
    base = asarray_f32(base, "base")
    values = asarray_f32(values, "values")
    if base.size == 0:
        raise ValueError("base input has no size")
    if base.shape != values.shape:
        raise ValueError("base is not the same size as values")
    gradient_type = int(gradient_type)
    if gradient_type not in (GradientType.MinMax,
                             GradientType.LinearRegression):
        raise ValueError("Unknown gradient type")
    h = int(halfwidth)
    default_gradient = float(default_gradient)
    both = np.isfinite(base) & np.isfinite(values)
    base0 = np.where(both, base, np.nan).astype(np.float32)
    values0 = np.where(both, values, np.nan).astype(np.float32)
    if gradient_type == GradientType.LinearRegression and on_host():
        out = native.calc_gradient_lr(base0, values0, h, min_num, min_range,
                                      bool(np.isfinite(min_range)),
                                      default_gradient)
        if out is not None:
            return out
    dev = api_device()
    solve = minmax_gradient if gradient_type == GradientType.MinMax \
        else lr_gradient
    return solve(upload(base0, dev), upload(values0, dev), h, min_num,
                 min_range, default_gradient).cpu().numpy()
