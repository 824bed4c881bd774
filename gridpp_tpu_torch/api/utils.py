"""Utility API functions (gridpp_tpu/api/utils.py, reference
src/api/util.cpp): statistics, quantiles, interpolation, vector
initialisers and coordinate helpers. numpy in and out, the reference's NaN
semantics; the reductions and the interpolation run on CPU tensors."""
from __future__ import annotations

import random

import numpy as np
import torch

from ..constants import MV, CoordinateType, Statistic
from ..core import coords
from ..core.grid import Grid, point_in_rectangle_np
from ..core.point import Point
from ..core.points import Points
from ..ops import stats as stats_ops

__all__ = [
    "calc_statistic", "calc_quantile", "num_missing_values",
    "get_lower_index", "get_upper_index", "interpolate", "init_ivec2",
    "init_vec2", "init_ivec3", "init_vec3", "calc_even_quantiles",
    "convert_coordinates", "is_valid_lat", "is_valid_lon",
    "point_in_rectangle", "compatible_size",
]


def _rand_choice(arr):
    valid = arr[np.isfinite(arr)]
    if valid.size == 0:
        return np.float32(MV)
    return np.float32(valid[random.randrange(valid.size)])


def calc_statistic(array, statistic):
    """Statistic over a 1D vector, or per row over a 2D vector
    (util.cpp:19-110,209-216)."""
    array = np.asarray(array, dtype=np.float32)
    statistic = int(statistic)
    if array.ndim == 1:
        if statistic == Statistic.RandomChoice:
            return float(_rand_choice(array))
        if array.size == 0:
            return float(MV)
        out = stats_ops.nan_statistic(torch.from_numpy(array), statistic)
        return float(out)
    if array.ndim == 2:
        if statistic == Statistic.RandomChoice:
            return np.array([_rand_choice(row) for row in array], np.float32)
        if array.shape[1] == 0:
            return np.full(array.shape[0], MV, np.float32)
        out = stats_ops.nan_statistic(torch.from_numpy(array), statistic)
        return out.numpy()
    raise ValueError("array must be 1D or 2D")


def calc_quantile(array, quantile=MV):
    """Quantile over the last axis (util.cpp:111-208).

    1D array -> scalar; 2D array (Y,X) -> (Y,); 3D array (Y,X,T) with 2D
    quantile field -> (Y,X).
    """
    array = np.asarray(array, dtype=np.float32)
    if array.ndim == 3:
        quantile = np.asarray(quantile, dtype=np.float32)
        if quantile.ndim != 2 or quantile.shape != array.shape[:2]:
            raise ValueError("Dimension mismatch between array and quantile")
        if array.shape[2] == 0:
            return np.full(array.shape[:2], MV, np.float32)
        _check_quantile_range(quantile)
        out = stats_ops.nan_quantile(torch.from_numpy(array),
                                     torch.from_numpy(quantile), axis=-1)
        return out.numpy()
    q = float(quantile) if np.isfinite(quantile) else MV
    if np.isfinite(q):
        _check_quantile_range(q)
    if array.ndim == 1:
        if array.size == 0:
            return float(MV)
        out = stats_ops.nan_quantile(torch.from_numpy(array), q, axis=-1)
        return float(out)
    if array.ndim == 2:
        if array.shape[1] == 0:
            return np.full(array.shape[0], MV, np.float32)
        out = stats_ops.nan_quantile(torch.from_numpy(array), q, axis=-1)
        return out.numpy()
    raise ValueError("array must be 1D, 2D, or 3D")


def _check_quantile_range(q):
    q = np.asarray(q)
    finite = q[np.isfinite(q)]
    if finite.size and (np.any(finite < 0) or np.any(finite > 1)):
        raise ValueError(
            "calc_quantile: Quantile must be between 0 and 1 inclusive")


def num_missing_values(array) -> int:
    array = np.asarray(array, dtype=np.float32)
    return int(np.sum(~np.isfinite(array)))


def get_lower_index(x, values) -> int:
    """Last index at or below x (util.cpp:339-357); first exact match wins."""
    values = np.asarray(values, dtype=np.float32)
    index = -1
    for i, v in enumerate(values):
        if not np.isfinite(v):
            continue
        if v < x:
            index = i
        elif v == x:
            return i
        else:
            break
    return index


def get_upper_index(x, values) -> int:
    """First index at or above x (util.cpp:358-376); last exact match wins."""
    values = np.asarray(values, dtype=np.float32)
    index = -1
    for i in range(len(values) - 1, -1, -1):
        v = values[i]
        if not np.isfinite(v):
            continue
        if v > x:
            index = i
        elif v == x:
            return i
        else:
            break
    return index


def interpolate(x, iX, iY):
    """Piecewise-linear interpolation (util.cpp:377-433)."""
    iX = np.asarray(iX, dtype=np.float32)
    iY = np.asarray(iY, dtype=np.float32)
    if iX.size != iY.size:
        raise ValueError("Dimension mismatch. Cannot interpolate.")
    scalar = np.ndim(x) == 0
    xs = np.atleast_1d(np.asarray(x, dtype=np.float32))
    if iX.size == 0:
        out = np.full(xs.shape, MV, np.float32)
        return float(out[0]) if scalar else out
    out = stats_ops.interpolate(torch.from_numpy(xs), torch.from_numpy(iX),
                                torch.from_numpy(iY)).numpy()
    return float(out[0]) if scalar else out


def init_ivec2(Y, X, value):
    return np.full((Y, X), int(value), dtype=np.int32)


def init_vec2(Y, X, value=MV):
    return np.full((Y, X), value, dtype=np.float32)


def init_ivec3(Y, X, E, value):
    return np.full((Y, X, E), int(value), dtype=np.int32)


def init_vec3(Y, X, E, value=MV):
    return np.full((Y, X, E), value, dtype=np.float32)


def calc_even_quantiles(values, num):
    """Evenly spaced quantile thresholds from data, dedup-aware
    (util.cpp:261-375)."""
    values = np.asarray(values, dtype=np.float32)
    num = int(num)
    size = values.size
    if num == 0 or size == 0:
        return np.zeros(0, np.float32)
    sorted_v = np.sort(values)
    if num >= size:
        return np.unique(sorted_v).astype(np.float32)  # all unique values
    lowest = sorted_v[0]
    highest = sorted_v[-1]
    count_lower = int(np.searchsorted(sorted_v, lowest, side="right"))
    quantiles = [lowest]
    if num == 2:
        if lowest != highest:
            quantiles.append(highest)
        return np.asarray(quantiles, np.float32)
    repeated_at_beginning = count_lower < size and count_lower > size // num
    if repeated_at_beginning:
        quantiles.append(sorted_v[count_lower])
    last_added = quantiles[-1]
    remaining = np.unique(sorted_v[sorted_v > last_added])
    if remaining.size > 0:
        num_left = num - len(quantiles)
        for i in range(1, num_left + 1):
            f = float(i) / num_left
            index = int(remaining.size * f) - 1
            if index >= 0:
                quantiles.append(remaining[index])
            else:
                raise RuntimeError("Internal error in calc_even_quantiles.")
    return np.asarray(quantiles, np.float32)


def convert_coordinates(lats, lons, type=CoordinateType.Geodetic):
    """Geodetic/Cartesian -> ECEF. Returns (status, x, y, z)
    (util.cpp:583-615)."""
    scalar = np.ndim(lats) == 0
    if not coords.is_valid_lat(lats, type) or not coords.is_valid_lon(lons, type):
        raise ValueError(f"Invalid coords: {lats},{lons}")
    x, y, z = coords.convert_coordinates_np(lats, lons, type)
    if scalar:
        return True, float(x), float(y), float(z)
    return (True, np.asarray(x, np.float32), np.asarray(y, np.float32),
            np.asarray(z, np.float32))


def is_valid_lat(lat, type=CoordinateType.Geodetic) -> bool:
    return coords.is_valid_lat(lat, type)


def is_valid_lon(lon, type=CoordinateType.Geodetic) -> bool:
    return coords.is_valid_lon(lon, type)


def point_in_rectangle(A: Point, B: Point, C: Point, D: Point, m: Point) -> bool:
    return bool(point_in_rectangle_np(
        A.lat, A.lon, B.lat, B.lon, C.lat, C.lon, D.lat, D.lon, m.lat, m.lon))


def compatible_size(a, b) -> bool:
    """Shape-compatibility checks (util.cpp:434-474)."""
    if isinstance(a, Grid):
        v = np.asarray(b, dtype=object if _ragged(b) else np.float32)
        if _ragged(b):
            return False
        v = np.asarray(b, np.float32)
        if v.size == 0:
            return True
        gy, gx = a.size()
        return v.shape[-2:] == (gy, gx)
    if isinstance(a, Points):
        v = np.asarray(b, np.float32)
        if v.size == 0 and v.ndim > 1:
            return True
        return v.shape[-1] == a.size()
    av = np.asarray(a, np.float32)
    bv = np.asarray(b, np.float32)
    if av.ndim == bv.ndim:
        return av.shape == bv.shape
    if av.ndim == 2 and bv.ndim == 3:
        return av.shape == bv.shape[:2]
    return False


def _ragged(x) -> bool:
    try:
        np.asarray(x, dtype=np.float32)
        return False
    except ValueError:
        return True
