"""Points->grid aggregation, neighbour counts and distances
(gridpp_tpu/api/gridding.py; reference src/api/{gridding,count,
distance}.cpp).

Host code on every route, as in gridpp_tpu: the spatial queries run on the
host index (the native cell hash's fused radius statistic where it
builds, else scipy), the statistics vectorized in numpy.
"""
from __future__ import annotations

import itertools

import numpy as np

from ..constants import MV, Statistic
from ..core.grid import Grid
from ..core.points import Points
from ..core import coords
from ._common import asarray_f32, check_points_compatible

__all__ = ["gridding", "gridding_nearest", "count", "distance"]


def _target_latlon_flat(target):
    if isinstance(target, Grid):
        return target.lats.ravel(), target.lons.ravel(), tuple(target.size())
    return target.lats, target.lons, (target.size(),)


def _segment_statistic(vals, lens, statistic, quantile=0.5):
    """Per-segment statistic over a segment-major flat value array.

    vals: concatenated group values (float32, segment-major);
    lens: (G,) group sizes. NaN values are skipped (util.cpp:19-110
    semantics); groups with no valid value yield NaN (Count: 0).
    Replaces per-group Python loops with one lexsort + fancy indexing.
    """
    g = lens.size
    statistic = int(statistic)
    valid = np.isfinite(vals)
    seg = np.repeat(np.arange(g, dtype=np.int64), lens)
    cnt = np.bincount(seg, weights=valid.astype(np.float64),
                      minlength=g).astype(np.int64)
    if statistic == Statistic.Count:
        return cnt.astype(np.float32)
    out = np.full(g, np.nan, np.float32)
    nz = cnt > 0
    if not nz.any():
        return out
    if statistic in (Statistic.Mean, Statistic.Sum):
        s = np.bincount(seg, weights=np.where(valid, vals, 0)
                        .astype(np.float64), minlength=g)
        res = s / np.maximum(cnt, 1) if statistic == Statistic.Mean else s
        out[nz] = res[nz].astype(np.float32)
        return out
    if statistic in (Statistic.Std, Statistic.Variance):
        v64 = np.where(valid, vals, 0).astype(np.float64)
        s = np.bincount(seg, weights=v64, minlength=g)
        s2 = np.bincount(seg, weights=v64 * v64, minlength=g)
        c = np.maximum(cnt, 1)
        var = np.maximum(s2 / c - (s / c) ** 2, 0.0)
        res = np.sqrt(var) if statistic == Statistic.Std else var
        out[nz] = res[nz].astype(np.float32)
        return out
    # Order statistics (Min/Max/Median/Quantile/RandomChoice): sort
    # within segments (NaNs sort last), then index per-segment positions
    order = np.lexsort((vals, seg))
    sv = vals[order]
    offs = np.zeros(g, np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    if statistic == Statistic.RandomChoice:
        r = np.floor(np.random.random_sample(g)
                     * np.maximum(cnt, 1)).astype(np.int64)
        r = np.minimum(r, np.maximum(cnt - 1, 0))
        out[nz] = sv[(offs + r)[nz]]
        return out
    if statistic == Statistic.Min:
        q = 0.0
    elif statistic == Statistic.Max:
        q = 1.0
    elif statistic == Statistic.Median:
        q = 0.5
    elif statistic == Statistic.Quantile:
        q = float(quantile)
    else:
        raise ValueError(f"Cannot compute statistic {statistic}")
    qn = q * np.maximum(cnt - 1, 0)
    lo = np.floor(qn).astype(np.int64)
    hi = np.ceil(qn).astype(np.int64)
    # clamp into the flat array: empty groups (masked out by nz below)
    # can place offs at the end of sv when they trail the last value
    last = np.minimum(offs + np.maximum(cnt - 1, 0), sv.size - 1)
    lv = sv[np.minimum(offs + lo, last)]
    uv = sv[np.minimum(offs + hi, last)]
    denom = (hi - lo).astype(np.float64)
    f = np.where(denom > 0, (qn - lo) / np.where(denom > 0, denom, 1), 0)
    out[nz] = (lv + (uv - lv) * f)[nz].astype(np.float32)
    return out


def gridding(target, points, values, radius, min_num, statistic):
    """Aggregate point values onto a grid/points by radius query
    (gridding.cpp:6-61)."""
    values = asarray_f32(values).ravel()
    check_points_compatible(points, values)
    if not np.isfinite(radius) or radius < 0:
        raise ValueError("radius must be >= 0")
    if min_num < 0:
        raise ValueError("min_num must be >= 0")
    qlats, qlons, oshape = _target_latlon_flat(target)
    statistic = int(statistic)
    q = np.stack(coords.convert_coordinates_np(
        qlats.astype(np.float64), qlons.astype(np.float64),
        points.get_coordinate_type()), axis=-1)
    if statistic in (Statistic.Mean, Statistic.Min, Statistic.Median,
                     Statistic.Max, Statistic.Quantile, Statistic.Std,
                     Statistic.Variance, Statistic.Sum, Statistic.Count):
        native = points.index.native
        if native is not None:
            out = native.radius_stat(q, float(radius), values, statistic,
                                     min_num=int(min_num))
            return out.reshape(oshape)
    lists = points.index.tree.query_ball_point(q, r=float(radius),
                                               workers=-1)
    ncell = len(lists)
    lens = np.fromiter((len(l) for l in lists), np.int64, count=ncell)
    flat_idx = np.fromiter(itertools.chain.from_iterable(lists), np.int64,
                           count=int(lens.sum()))
    vals = values[flat_idx]
    # Note: reference computes the statistic whenever min_num allows, even
    # with zero points (calc_statistic of empty -> MV; Count -> 0)
    statistic = int(statistic)
    out = np.full(ncell, MV, np.float32)
    allowed = lens >= min_num if min_num > 0 else np.ones(ncell, bool)
    nonzero = allowed & (lens > 0)
    res = _segment_statistic(vals, lens, statistic)
    out[nonzero] = res[nonzero]
    if statistic == Statistic.Count:
        out[allowed & (lens == 0)] = 0
    return out.reshape(oshape)


def gridding_nearest(target, points, values, min_num, statistic):
    """Scatter each point to its nearest cell, then reduce
    (gridding.cpp:63-131)."""
    values = asarray_f32(values).ravel()
    check_points_compatible(points, values)
    if min_num < 0:
        raise ValueError("min_num must be >= 0")
    qlats, qlons, oshape = _target_latlon_flat(target)
    n_out = int(np.prod(oshape))
    if isinstance(target, Grid):
        # Scatter map target-cell-of-each-obs is pure geometry: reuse the
        # cached per-(grid, points) nearest map (the same amortization the
        # downscaling ops use) instead of re-running the NN query per call
        nn = target.nearest_map(points.lats, points.lons, cache_obj=points)
    else:
        nn = target.index.nearest(points.lats.astype(np.float64),
                                  points.lons.astype(np.float64))
    statistic = int(statistic)
    counts = np.bincount(nn, minlength=n_out)
    out = np.full(n_out, MV, np.float32)
    occupied = counts > 0
    allowed = occupied if min_num <= 0 else occupied & (counts >= min_num)
    if statistic in (Statistic.Mean, Statistic.Sum, Statistic.Count):
        valid = np.isfinite(values)
        vsum = np.bincount(nn, weights=np.where(valid, values, 0),
                           minlength=n_out)
        vcnt = np.bincount(nn, weights=valid.astype(np.float64),
                           minlength=n_out)
        if statistic == Statistic.Count:
            out[allowed] = vcnt[allowed]
        elif statistic == Statistic.Mean:
            res = np.where(vcnt > 0, vsum / np.maximum(vcnt, 1), MV)
            out[allowed] = res[allowed]
        else:
            res = np.where(vcnt > 0, vsum, MV)
            out[allowed] = res[allowed]
    else:
        order = np.argsort(nn, kind="stable")
        sorted_v = values[order]  # cell-major
        lens = np.bincount(nn, minlength=n_out).astype(np.int64)
        res = _segment_statistic(sorted_v, lens, statistic)
        res = np.where(np.isfinite(res), res, MV)
        out[allowed] = res[allowed]
    return out.astype(np.float32).reshape(oshape)


def count(source, target, radius):
    """Neighbour counts within radius (count.cpp)."""
    qlats, qlons, oshape = _target_latlon_flat(target)
    out = source.index.radius_counts(qlats.astype(np.float64),
                                     qlons.astype(np.float64),
                                     float(radius))
    return out.astype(np.float32).reshape(oshape)


def distance(source, target, num=1):
    """Distance to the num-th nearest source point (distance.cpp).

    k-nearest found in chord space; reported distance is great-circle
    (the reference's calc_distance on the found neighbours).
    """
    if source.get_coordinate_type() != target.get_coordinate_type():
        raise ValueError("Incompatible coordinate types")
    qlats, qlons, oshape = _target_latlon_flat(target)
    qlats = qlats.astype(np.float64).ravel()
    qlons = qlons.astype(np.float64).ravel()
    index = source.index
    idx, _ = index.knearest(qlats, qlons, int(num))
    slats = index.lats
    slons = index.lons
    valid = idx >= 0
    idxc = np.where(valid, idx, 0)
    d = coords.calc_distance_np(qlats[:, None], qlons[:, None],
                                slats[idxc], slons[idxc],
                                source.get_coordinate_type())
    d = np.where(valid, d, 0.0)
    out = d.max(axis=1).astype(np.float32)
    return out.reshape(oshape)
