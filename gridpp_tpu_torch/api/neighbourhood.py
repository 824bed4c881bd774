"""Neighbourhood statistics, numpy API (gridpp_tpu/api/neighbourhood.py;
reference src/api/neighbourhood.cpp).

numpy in, numpy out, on the host, as in the reference (whose bindings work
in host memory): each function takes gridpp_tpu's route, the native host
kernels (native/) where gridpp_tpu uses them, else the port's tensor ops
(ops/neighbourhood.py) on CPU tensors. The device entry points are the ops
themselves and `Pipeline`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..constants import MV, Statistic
from ..ops import neighbourhood as ops
from ..ops import stats as stats_ops
from ._common import asarray_f32
from .utils import calc_even_quantiles, calc_statistic

__all__ = [
    "neighbourhood", "neighbourhood_brute_force", "neighbourhood_quantile",
    "neighbourhood_quantile_fast", "get_neighbourhood_thresholds",
    "neighbourhood_ens", "neighbourhood_quantile_ens",
    "neighbourhood_quantile_ens_fast",
]

_MEANSUM = (Statistic.Mean, Statistic.Sum, Statistic.Count, Statistic.Std,
            Statistic.Variance)


def _check_halfwidth(halfwidth):
    if halfwidth < 0:
        raise ValueError("Half width must be > 0")


def _window_stack_np(x: np.ndarray, h: int) -> np.ndarray:
    """Host window stack (Y, X, W) with NaN padding outside the domain."""
    w = 2 * h + 1
    xp = np.pad(x, ((h, h), (h, h)), constant_values=np.nan)
    ny, nx = x.shape
    parts = [xp[dy:dy + ny, dx:dx + nx]
             for dy in range(w) for dx in range(w)]
    return np.stack(parts, axis=-1)


def _random_pick(stack: np.ndarray) -> np.ndarray:
    """A uniform pick among the valid values along the last axis."""
    stack = np.sort(stack, axis=-1)  # NaNs last
    n = np.sum(np.isfinite(stack), axis=-1)
    r = np.floor(np.random.random_sample(n.shape) * n).astype(np.int64)
    r = np.minimum(r, np.maximum(n - 1, 0))
    out = np.take_along_axis(stack, r[..., None], axis=-1)[..., 0]
    return np.where(n > 0, out, np.nan).astype(np.float32)


def _random_choice_window(x: np.ndarray, h: int) -> np.ndarray:
    """Windowed RandomChoice (util.cpp:75-96): a host random pick among
    the valid values of each window."""
    return _random_pick(_window_stack_np(x, h))


def _host_ops(fn, input: np.ndarray, *args) -> np.ndarray:
    return fn(torch.from_numpy(np.ascontiguousarray(input)), *args).numpy()


def neighbourhood(input, halfwidth, statistic):
    """Moving-window statistic of a (Y, X) field, or of a (Y, X, E)
    ensemble after collapsing its members with the same statistic
    (neighbourhood.cpp:12-241)."""
    _check_halfwidth(halfwidth)
    statistic = int(statistic)
    h = int(halfwidth)
    if statistic == Statistic.Quantile:
        raise ValueError(
            "Use neighbourhood_quantile for computing neighbourhood quantiles")
    input = asarray_f32(input)
    if input.size == 0:
        return np.zeros((0, 0), np.float32)
    if input.ndim == 3:
        if statistic == Statistic.RandomChoice:
            flat = np.apply_along_axis(
                lambda r: calc_statistic(r, statistic), -1, input)
            return _random_choice_window(flat.astype(np.float32), h)
        input = stats_ops.nan_statistic(torch.from_numpy(input), statistic,
                                        axis=-1).numpy()
    elif input.ndim != 2:
        raise ValueError("input must be 2D or 3D")
    elif statistic == Statistic.RandomChoice:
        return _random_choice_window(input, h)
    host = None
    if statistic in _MEANSUM:
        host = native.nb_meansum(input, h, statistic)
    elif statistic == Statistic.Median:
        # no O(1) path for Median: the native brute kernel, as
        # neighbourhood.cpp:236-238 falls back
        host = native.nb_brute(input, h, statistic)
    if host is not None:
        return host
    return _host_ops(ops.neighbourhood, input, h, statistic)


def neighbourhood_brute_force(input, halfwidth, statistic):
    """Exact windowed statistic (neighbourhood.cpp:528-539)."""
    _check_halfwidth(halfwidth)
    statistic = int(statistic)
    h = int(halfwidth)
    input = asarray_f32(input)
    if input.size == 0:
        return np.zeros((0, 0), np.float32)
    if statistic == Statistic.RandomChoice:
        if input.ndim == 3:
            stacks = [_window_stack_np(input[:, :, e], h)
                      for e in range(input.shape[2])]
            return _random_pick(np.concatenate(stacks, axis=-1))
        return _random_choice_window(input, h)
    if input.ndim not in (2, 3):
        raise ValueError("input must be 2D or 3D")
    host = native.nb_brute(input, h, statistic)
    if host is not None:
        return host
    fn = (ops.neighbourhood_brute_force if input.ndim == 2
          else ops.neighbourhood_brute_force_ens)
    return _host_ops(fn, input, h, statistic)


def neighbourhood_quantile(input, quantile, halfwidth):
    """Exact windowed quantile (neighbourhood.cpp:534-539)."""
    _check_halfwidth(halfwidth)
    quantile = float(quantile)
    if np.isfinite(quantile) and (quantile < 0 or quantile > 1):
        raise ValueError(
            "calc_quantile: Quantile must be between 0 and 1 inclusive")
    input = asarray_f32(input)
    if input.size == 0:
        return np.zeros((0, 0), np.float32)
    if input.ndim not in (2, 3):
        raise ValueError("input must be 2D or 3D")
    host = native.nb_brute(input, int(halfwidth), int(Statistic.Quantile),
                           quantile)
    if host is not None:
        return host
    fn = (ops.neighbourhood_quantile if input.ndim == 2
          else ops.neighbourhood_quantile_ens)
    return _host_ops(fn, input, quantile, int(halfwidth))


def neighbourhood_quantile_fast(input, quantile, halfwidth, thresholds):
    """Threshold-CDF approximate windowed quantile
    (neighbourhood.cpp:296-527)."""
    _check_halfwidth(halfwidth)
    input = asarray_f32(input)
    thresholds = asarray_f32(thresholds, "thresholds").ravel()
    if input.size == 0:
        return np.zeros((0, 0), np.float32)
    if input.ndim not in (2, 3):
        raise ValueError("input must be 2D or 3D")
    ny, nx = input.shape[:2]
    qarr = np.asarray(quantile, dtype=np.float32)
    if qarr.ndim == 0:
        q = qarr[()]
    elif qarr.shape == (1, 1):
        q = qarr[0, 0]
    elif qarr.shape == (ny, nx):
        q = qarr
    else:
        raise ValueError(
            "Quantile must be the same size as input, or size (1, 1)")
    qv = np.asarray(q)
    if np.any(np.isfinite(qv) & ((qv < 0) | (qv > 1))):
        raise ValueError("All quantiles must be >= 0 and <= 1")
    if thresholds.size == 0:
        return np.full((ny, nx), MV, np.float32)
    if input.ndim == 2:
        host = native.nb_quantile_fast(
            input, int(halfwidth), thresholds,
            q if np.ndim(q) else None,
            float(q) if not np.ndim(q) else 0.0)
        if host is not None:
            return host
    return ops.neighbourhood_quantile_fast(
        torch.from_numpy(input), torch.from_numpy(np.asarray(q)),
        int(halfwidth), torch.from_numpy(thresholds)).numpy()


def get_neighbourhood_thresholds(input, num_thresholds):
    """Sample even data quantiles for use as thresholds
    (neighbourhood.cpp:243-295)."""
    if num_thresholds <= 0:
        raise ValueError("num_thresholds must be > 0")
    input = asarray_f32(input)
    if input.size == 0:
        return np.zeros(0, np.float32)
    values = input.ravel()
    values = values[np.isfinite(values)]
    return calc_even_quantiles(np.sort(values), int(num_thresholds))


# Deprecated aliases (neighbourhood.cpp:541-552)
def neighbourhood_ens(input, halfwidth, statistic):
    return neighbourhood(input, halfwidth, statistic)


def neighbourhood_quantile_ens(input, quantile, halfwidth):
    return neighbourhood_quantile(input, quantile, halfwidth)


def neighbourhood_quantile_ens_fast(input, quantile, halfwidth, thresholds):
    return neighbourhood_quantile_fast(input, quantile, halfwidth, thresholds)
