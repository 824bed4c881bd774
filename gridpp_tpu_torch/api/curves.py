"""Calibration API: apply_curve, quantile mapping, monotonize and the
metric optimizer (gridpp_tpu/api/curves.py; reference src/api/{curve,
quantile_mapping,metric_optimizer}.cpp).

numpy in, numpy out. apply_curve's route follows the API's device, read
once per call (api/_common.api_device): the native C++ curve on the host
(csrc apply_curve_1d / apply_curve_percell), ops/curves.apply_curve on a
device. Building a curve (monotonize, quantile mapping, the metric
optimizer's bounded Brent search) stays host numpy and scipy, as in
gridpp_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..constants import MV, Metric
from ..ops import curves as ops
from ._common import api_device, asarray_f32, on_host, upload

__all__ = [
    "apply_curve", "monotonize_curve", "quantile_mapping_curve",
    "metric_optimizer_curve", "get_optimal_threshold", "calc_score",
]


def _check_curve(curve_ref, curve_fcst):
    if curve_ref.shape != curve_fcst.shape:
        raise ValueError("curve_ref and curve_fcst must be the same size")
    if curve_ref.size == 0:
        raise ValueError("curve_ref and curve_fcst cannot have size 0")


def apply_curve(fcst, curve_ref, curve_fcst, policy_below, policy_above):
    """Apply a calibration curve (curve.cpp:6-133): a scalar, 1-D or 2-D
    fcst with a shared 1-D curve, or a 2-D fcst with per-cell (Y, X, C)
    curves."""
    curve_ref = asarray_f32(curve_ref, "curve_ref")
    curve_fcst = asarray_f32(curve_fcst, "curve_fcst")
    scalar = np.ndim(fcst) == 0
    fcst = np.atleast_1d(asarray_f32(fcst, "fcst"))
    if curve_ref.ndim == 3:
        if curve_ref.shape != curve_fcst.shape:
            raise ValueError("curve_ref and curve_fcst dimension sizes mismatch")
        if fcst.shape != curve_ref.shape[:2]:
            raise ValueError("Fcst and curve_ref dimension sizes mismatch")
    else:
        _check_curve(curve_ref, curve_fcst)
    out = None
    if on_host():
        out = native.apply_curve(fcst, curve_ref, curve_fcst,
                                 int(policy_below), int(policy_above))
    if out is None:
        dev = api_device()
        out = ops.apply_curve(
            *(upload(a, dev) for a in (fcst, curve_ref, curve_fcst)),
            int(policy_below), int(policy_above)).cpu().numpy()
    return float(out[0]) if scalar else out


def monotonize_curve(curve_ref, curve_fcst):
    """Remove non-monotonic sections of a curve (curve.cpp:134-250).

    Host-side curve preparation. Returns (curve_ref, curve_fcst).
    """
    curve_ref = asarray_f32(curve_ref, "curve_ref").ravel()
    curve_fcst = asarray_f32(curve_fcst, "curve_fcst").ravel()
    _check_curve(curve_ref, curve_fcst)

    keep = np.isfinite(curve_ref) & np.isfinite(curve_fcst)
    x = curve_fcst[keep]
    y = curve_ref[keep]
    n = x.size
    new_indices = [0]
    tol = 0.1
    deviation = False
    x_min = x[0] if n else 0.0
    x_max = x[0] if n else 0.0
    prev = x[0] if n else 0.0
    for i in range(1, n):
        xi = x[i]
        if deviation:
            if xi < x_min:
                x_min = xi
            if xi > x_max + tol:
                # Past the deviation: drop kept points above x_min
                while new_indices:
                    idx = new_indices[-1]
                    if x[idx] < x_min - tol:
                        break
                    new_indices.pop()
                new_indices.append(i)
                deviation = False
                prev = xi
                x_max = xi
        else:
            if xi <= prev + tol:
                deviation = True
                x_min = xi
            else:
                new_indices.append(i)
                prev = xi
                x_max = xi
    if deviation:
        while new_indices and x[new_indices[-1]] >= x_min:
            new_indices.pop()
    idx = np.asarray(new_indices, dtype=np.int64)
    return y[idx].astype(np.float32), x[idx].astype(np.float32)


def quantile_mapping_curve(ref, fcst, quantiles=()):
    """Build a quantile-mapping curve (quantile_mapping.cpp:5-46).

    Returns (curve_ref, curve_fcst) = sorted reference and forecast values,
    optionally subsampled at the given quantile levels.
    """
    ref = asarray_f32(ref, "ref").ravel()
    fcst = asarray_f32(fcst, "fcst").ravel()
    if ref.size != fcst.size:
        raise ValueError("ref and fcst must be of the same size")
    quantiles = asarray_f32(quantiles, "quantiles").ravel()
    if quantiles.size:
        if np.any(~np.isfinite(quantiles)) or np.any(quantiles > 1) or \
                np.any(quantiles < 0):
            raise ValueError("Quantiles must be >= 0 and <= 1")
    if ref.size <= 1:
        return ref.copy(), fcst.copy()
    ref_sort = np.sort(ref)
    fcst_sort = np.sort(fcst)
    if quantiles.size == 0:
        return ref_sort, fcst_sort
    s = fcst_sort.size
    # NOTE: indexes the *unsorted* arrays, faithfully reproducing
    # quantile_mapping.cpp:40-43
    index = (quantiles * (s - 1)).astype(np.int64)
    return ref[index].astype(np.float32), fcst[index].astype(np.float32)


def calc_score(*args):
    """calc_score(a, b, c, d, metric) or calc_score(ref, fcst, threshold[,
    fthreshold], metric) (metric_optimizer.cpp:185-244), on the host."""
    if len(args) == 5 and np.ndim(args[0]) == 0 and not isinstance(
            args[0], (list, tuple, np.ndarray)):
        a, b, c, d, metric = args
        return float(ops.calc_score(a, b, c, d, int(metric)))
    if len(args) == 4:
        ref, fcst, threshold, metric = args
        fthreshold = threshold
    elif len(args) == 5:
        ref, fcst, threshold, fthreshold, metric = args
    else:
        raise ValueError("Invalid arguments to calc_score")
    ref = torch.from_numpy(asarray_f32(ref, "ref").ravel())
    fcst = torch.from_numpy(asarray_f32(fcst, "fcst").ravel())
    a, b, c, d = ops.contingency(ref, fcst, float(threshold),
                                 float(fthreshold))
    return float(ops.calc_score(a, b, c, d, int(metric)))


def _score_scalar(a, b, c, d, metric):
    """Host scalar calc_score in f32 (metric_optimizer.cpp:207-244) —
    same arithmetic as ops.calc_score without a device dispatch."""
    a = np.float32(a)
    b = np.float32(b)
    c = np.float32(c)
    d = np.float32(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        if metric == Metric.Ets:
            n = a + b + c + d
            ar = (a + b) / n * (a + c)
            denom = a + b + c - ar
            return float(np.nan) if denom == 0 else float((a - ar) / denom)
        if metric == Metric.Ts:
            return float(a / (a + b + c))
        if metric == Metric.Pc:
            return float((a + d) / (a + b + c + d))
        if metric == Metric.Kss:
            denom = (a + c) * (b + d)
            return float(np.nan) if denom == 0 else \
                float((a * d - b * c) / denom)
        if metric == Metric.Bias:
            return 1.0 if b == c else float(1 - np.abs(b - c) / (b + c))
        if metric == Metric.Hss:
            denom = (a + c) * (c + d) + (a + b) * (b + d)
            return float(np.nan) if denom == 0 else \
                float(2.0 * (a * d - b * c) / denom)
    raise ValueError("Unknown metric")


def _score_neg(ref, fcst, threshold, x, metric):
    """-score of forecast threshold x (the Brent objective)."""
    fpos = fcst > x
    rpos = ref > threshold
    rneg = ref <= threshold
    a = float(np.sum(fpos & rpos))
    b = float(np.sum(fpos & rneg))
    c = float(np.sum(~fpos & rpos))
    d = float(np.sum(~fpos & rneg))
    return -_score_scalar(a, b, c, d, metric)


def get_optimal_threshold(ref, fcst, threshold, metric):
    """Forecast threshold maximizing the metric (metric_optimizer.cpp:129-184).

    Coarse 10-bin scan then bounded Brent minimization of -score, with the
    reference's degenerate-solution rejection rules.
    """
    from scipy.optimize import minimize_scalar
    ref = asarray_f32(ref, "ref").ravel()
    fcst = asarray_f32(fcst, "fcst").ravel()
    if ref.size != fcst.size:
        raise ValueError("ref and fcst not the same size")
    metric = int(metric)
    threshold = float(threshold)
    fmin = float(np.min(fcst))
    fmax = float(np.max(fcst))

    # Presort the forecasts by observed class ONCE; every objective
    # evaluation is then two binary searches instead of four full-array
    # reductions (the reference re-scans per Brent iteration,
    # metric_optimizer.cpp:189-206 — semantics identical: NaN ref rows
    # count in neither class; NaN fcst rows count as "not positive").
    rpos = ref > threshold
    rneg = ref <= threshold  # NaN ref is in neither
    fp = np.sort(fcst[rpos])
    fn = np.sort(fcst[rneg])
    npos = fp.size
    nneg = fn.size
    nfp = int(np.sum(np.isfinite(fp)))  # NaNs sort last
    nfn = int(np.sum(np.isfinite(fn)))

    def func(x):
        a = nfp - int(np.searchsorted(fp[:nfp], x, side="right"))
        b = nfn - int(np.searchsorted(fn[:nfn], x, side="right"))
        c = npos - a
        d = nneg - b
        return -_score_scalar(a, b, c, d, metric)

    b_count = 10
    bins = [fmin + (fmax - fmin) / (b_count - 1) * b for b in range(b_count)]
    vals = [func(b) for b in bins]
    min_index = int(np.nanargmin(vals)) if np.any(np.isfinite(vals)) else 0
    left = bins[max(min_index - 1, 0)]
    right = bins[min(min_index + 1, b_count - 1)]
    if left == right:
        return MV
    res = minimize_scalar(func, bounds=(left, right), method="bounded",
                          options={"xatol": 1e-8})
    x = float(res.x)
    score = -float(res.fun)
    if not np.isfinite(score):
        return MV
    if score <= 0.0001:  # remove_near_zero
        return MV
    # remove_at_boundary
    s0 = -func(fmin)
    s1 = -func(fmax)
    if abs(res.fun - s0) < 0.001 or abs(res.fun - s1) < 0.001:
        return MV
    return x


def metric_optimizer_curve(ref, fcst, thresholds, metric):
    """Optimal forecast threshold for each obs threshold
    (metric_optimizer.cpp:105-127). Returns (curve_ref, curve_fcst)."""
    ref = asarray_f32(ref, "ref").ravel()
    fcst = asarray_f32(fcst, "fcst").ravel()
    if ref.size != fcst.size:
        raise ValueError("ref and fcst not the same size")
    thresholds = asarray_f32(thresholds, "thresholds").ravel()
    out_ref = []
    out_fcst = []
    for t in thresholds:
        value = get_optimal_threshold(ref, fcst, float(t), metric)
        if np.isfinite(value):
            out_ref.append(value)
            out_fcst.append(float(t))
    return (np.asarray(out_ref, np.float32), np.asarray(out_fcst, np.float32))
