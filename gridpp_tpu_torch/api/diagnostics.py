"""Meteorological diagnostics API (gridpp_tpu/api/diagnostics.py):
scalar/vector dispatch and validation.

The elementwise diagnostics run ops/diagnostics.py on the API's device
(api/_common.api_device); gamma_inv is scipy's gammaincinv on the host on
every route, as in gridpp_tpu.
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import MV
from ..ops import diagnostics as ops
from ._common import api_device, asarray_f32, upload

__all__ = ["dewpoint", "relative_humidity", "wetbulb", "pressure",
           "sea_level_pressure", "qnh", "wind_speed", "wind_direction",
           "gamma_inv"]


def _dispatch(fn, *args, names=None, check_sizes=True):
    scalar = all(np.ndim(a) == 0 for a in args)
    arrs = [np.atleast_1d(asarray_f32(a)) for a in args]
    n = arrs[0].size
    if check_sizes:
        for a in arrs[1:]:
            if a.size != n:
                raise ValueError(
                    "Input arguments must be of the same size")
    dev = api_device()
    out = fn(*[upload(a, dev) for a in arrs]).cpu().numpy()
    return float(out[0]) if scalar else out


def dewpoint(temperature, relative_humidity):
    """Dewpoint temperature [K] (humidity.cpp:5-31)."""
    if np.ndim(temperature) > 0 and \
            np.size(temperature) != np.size(relative_humidity):
        raise ValueError(
            "Temperature and relative_humidity vectors are not the same size")
    return _dispatch(ops.dewpoint, temperature, relative_humidity)


def relative_humidity(temperature, dewpoint):
    """Relative humidity [0,1] (humidity.cpp:33-90)."""
    if np.ndim(temperature) > 0 and \
            np.size(temperature) != np.size(dewpoint):
        raise ValueError(
            "Temperature and dewpoint vectors are not the same size")
    return _dispatch(ops.relative_humidity, temperature, dewpoint)


def wetbulb(temperature, pressure, relative_humidity):
    """Wet-bulb temperature [K] (humidity.cpp:82-122)."""
    if np.ndim(temperature) > 0:
        if np.size(temperature) != np.size(pressure):
            raise ValueError(
                "Temperature and pressure vectors are not the same size")
        if np.size(temperature) != np.size(relative_humidity):
            raise ValueError("Temperature and relative_humidity vectors are "
                             "not the same size")
    return _dispatch(ops.wetbulb, temperature, pressure, relative_humidity)


def pressure(ielev, oelev, ipressure, itemperature=288.15):
    """Hydrostatic pressure adjustment [Pa] (pressure.cpp:5-27)."""
    return _dispatch(ops.pressure, ielev, oelev, ipressure, itemperature)


def sea_level_pressure(ps, altitude, temperature, rh=MV, dewpoint=MV):
    """WMO sea-level pressure [Pa] (pressure.cpp:28-93)."""
    scalar = np.ndim(ps) == 0
    ps_a = np.atleast_1d(asarray_f32(ps))
    alt_a = np.atleast_1d(asarray_f32(altitude))
    t_a = np.atleast_1d(asarray_f32(temperature))
    rh_a = np.atleast_1d(asarray_f32(rh))
    td_a = np.atleast_1d(asarray_f32(dewpoint))
    n = ps_a.size
    if not scalar:
        for a in (alt_a, t_a, rh_a, td_a):
            if a.size != n:
                raise ValueError("slp: Input arguments must be of the same size")
    else:
        alt_a, t_a, rh_a, td_a = (np.broadcast_to(a, (n,)).astype(np.float32)
                                  for a in (alt_a, t_a, rh_a, td_a))
    if not np.isfinite(alt_a).all():
        raise RuntimeError("sea_level_pressure: altitude is NAN")
    if not np.isfinite(t_a).all():
        raise RuntimeError("sea_level_pressure: temperature is NAN")
    bad = (ps_a < 0) | (t_a < 0)
    bad |= np.where(np.isfinite(rh_a), (rh_a < 0) | (rh_a > 1), False)
    bad |= np.where(np.isfinite(td_a), td_a < 0, False)
    if bad.any():
        raise RuntimeError("sea_level_pressure: unphysical values in input")
    dev = api_device()
    out = ops.sea_level_pressure(
        *(upload(a, dev) for a in (ps_a, alt_a, t_a, rh_a, td_a))
    ).cpu().numpy()
    return float(out[0]) if scalar else out


def qnh(pressure, altitude):
    """QNH pressure [Pa] (qnh.cpp:6-41)."""
    if np.ndim(pressure) > 0 and np.size(pressure) != np.size(altitude):
        raise ValueError("Pressure and altitude vectors are not the same size")
    return _dispatch(ops.qnh, pressure, altitude)


def wind_speed(xwind, ywind):
    if np.ndim(xwind) > 0 and np.size(xwind) != np.size(ywind):
        raise ValueError("xwind and ywind must be of the same size")
    return _dispatch(ops.wind_speed, xwind, ywind)


def wind_direction(xwind, ywind):
    """Meteorological wind direction [deg] (wind.cpp:21-38)."""
    if np.ndim(xwind) > 0 and np.size(xwind) != np.size(ywind):
        raise ValueError("xwind and ywind must be of the same size")
    return _dispatch(ops.wind_direction, xwind, ywind)


def gamma_inv(levels, shape, scale):
    """Gamma distribution quantiles (distribution.cpp:5-33), vectorized
    via scipy's gammaincinv instead of a per-element Boost loop."""
    from scipy import special
    levels = asarray_f32(levels, "levels").ravel()
    shape = asarray_f32(shape, "shape").ravel()
    scale = asarray_f32(scale, "scale").ravel()
    if np.any(~np.isfinite(levels)) or np.any(levels < 0) or \
            np.any(levels > 1):
        raise ValueError("Levels must be on the interval [0, 1].")
    if np.any(~np.isfinite(shape)) or np.any(shape <= 0):
        raise ValueError("Shapes must be > 0.")
    if np.any(~np.isfinite(scale)) or np.any(scale <= 0):
        raise ValueError("Scale must be > 0.")
    sh64 = shape.astype(np.float64)
    lv64 = levels.astype(np.float64)
    out = np.empty(sh64.shape, np.float64)
    # scipy's ufunc releases the GIL; split across cores
    import concurrent.futures as _fut
    ncpu = min(len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
               else (os.cpu_count() or 1), 8)
    if ncpu > 1 and sh64.size >= 65536:
        bounds = np.linspace(0, sh64.size, ncpu + 1).astype(np.int64)
        with _fut.ThreadPoolExecutor(max_workers=ncpu) as ex:
            list(ex.map(lambda i: special.gammaincinv(
                sh64[bounds[i]:bounds[i + 1]], lv64[bounds[i]:bounds[i + 1]],
                out=out[bounds[i]:bounds[i + 1]]), range(ncpu)))
    else:
        special.gammaincinv(sh64, lv64, out=out)
    return (out * scale).astype(np.float32)
