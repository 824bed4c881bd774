"""Meteorological diagnostics as elementwise tensor ops
(gridpp_tpu/ops/diagnostics.py; reference src/api/{humidity,pressure,wind,
qnh}.cpp, scalar formulas in OpenMP loops there). Torch ops on whatever
device the tensors lie, as they are XLA ops in gridpp_tpu, not a kernel
port.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dewpoint", "relative_humidity", "wetbulb", "pressure",
           "sea_level_pressure", "qnh", "wind_speed", "wind_direction"]

# Saturation vapour pressure lookup table, 5 K steps from 173.16 K
# (humidity.cpp:35-42, from metno/wdb2ts)
EWT = np.array([
    .000034, .000089, .000220, .000517, .001155, .002472,
    .005080, .01005, .01921, .03553, .06356, .1111,
    .1891, .3139, .5088, .8070, 1.2540, 1.9118,
    2.8627, 4.2148, 6.1078, 8.7192, 12.272, 17.044,
    23.373, 31.671, 42.430, 56.236, 73.777, 95.855,
    123.40, 157.46, 199.26, 250.16, 311.69, 385.56,
    473.67, 578.09, 701.13, 845.28, 1013.25], np.float32)


def _valid(*xs):
    out = torch.isfinite(xs[0])
    for x in xs[1:]:
        out = out & torch.isfinite(x)
    return out


def dewpoint(temperature, relative_humidity):
    """Dewpoint from T and RH (humidity.cpp:5-21, the wdb2ts Magnus form)."""
    temp_c = temperature - 273.15
    e = relative_humidity * 0.611 * torch.exp(
        (17.63 * temp_c) / (temp_c + 243.04))
    log_e = torch.log(e)
    td_c = (116.9 + 243.04 * log_e) / (16.78 - log_e)
    out = torch.minimum(td_c + 273.15, temperature)
    return torch.where(_valid(temperature, relative_humidity), out,
                       torch.nan)


def _ewt_lookup(temp):
    ewt = torch.as_tensor(EWT, device=temp.device)
    x = torch.clamp((temp - 173.16) * 0.2, 0.0, 39.0)
    idx = torch.clamp(x.to(torch.int32), 0, 39).long()
    frac = x - idx.to(x.dtype)
    return ewt[idx] + (ewt[idx + 1] - ewt[idx]) * frac


def relative_humidity(temperature, dewpoint):
    """RH from T and dewpoint via the wdb2ts saturation table
    (humidity.cpp:33-80)."""
    rh = torch.clamp(_ewt_lookup(dewpoint) / _ewt_lookup(temperature),
                     0.0, 1.0)
    rh = torch.where(temperature <= dewpoint, 1.0, rh)
    return torch.where(_valid(temperature, dewpoint), rh, torch.nan)


def wetbulb(temperature, pressure, relative_humidity):
    """Wet-bulb temperature (humidity.cpp:82-103)."""
    temp_c = temperature - 273.15
    e = relative_humidity * 0.611 * torch.exp(
        (17.63 * temp_c) / (temp_c + 243.04))
    log_e = torch.log(e)
    td = (116.9 + 243.04 * log_e) / (16.78 - log_e)
    gamma = 0.00066 * pressure / 1000
    delta = (4098 * e) / torch.square(td + 243.04)
    denom = gamma + delta
    wb = (gamma * temp_c + delta * td) / torch.where(denom == 0, 1.0, denom)
    valid = (_valid(temp_c, pressure, relative_humidity) & (denom != 0)
             & (temp_c > -243.04) & (relative_humidity > 0))
    return torch.where(valid, wb + 273.15, torch.nan)


def pressure(ielev, oelev, ipressure, itemperature):
    """Hydrostatic pressure adjustment (pressure.cpp:5-14)."""
    g0 = 9.80665
    m = 0.0289644
    r = 8.3144598
    out = ipressure * torch.exp(-g0 * m * (oelev - ielev)
                                / (r * itemperature))
    return torch.where(_valid(ielev, oelev, ipressure, itemperature), out,
                       torch.nan)


def sea_level_pressure(ps, altitude, temperature, rh, dewpoint):
    """WMO sea-level pressure reduction (pressure.cpp:28-76). The API
    layer validates the inputs (the reference throws)."""
    t = temperature - 273.15
    ts = 273.15 + t
    g = 9.80665
    r = 287.05
    a = 0.0065
    ch = 0.12
    ps_hpa = ps * 0.01

    has_rh = torch.isfinite(rh)
    has_td = torch.isfinite(dewpoint)
    es = 6.11 * torch.pow(10.0, (7.5 * t) / (237.3 + t))
    e_rh = rh * es
    aa, bb, cc = 17.625, 243.04, 6.1094
    td_from_rh = (bb * torch.log(e_rh / cc)) / (aa - torch.log(e_rh / cc))
    td_c = dewpoint - 273.15
    e_td = 6.11 * torch.pow(10.0, (7.5 * td_c) / (237.3 + td_c))
    td = torch.where(has_rh, td_from_rh,
                     torch.where(has_td, td_c, t - 3.0))
    e = torch.where(has_rh, e_rh, torch.where(has_td, e_td, 0.0))

    slp_high = ps_hpa * torch.exp(
        (g * altitude / r) / (ts + 0.5 * a * altitude + e * ch))
    e_tv = 6.11 * torch.pow(10.0, (7.5 * td) / (237.7 + td))
    tv = (273.15 + t) / (1 - 0.379 * (e_tv / ps_hpa))
    slp_low = ps_hpa + ps_hpa * altitude / (29.27 * tv)
    slp = torch.where(altitude >= 50.0, slp_high, slp_low)
    return slp * 100.0


def qnh(pressure, altitude):
    """ICAO standard-atmosphere QNH (qnh.cpp:6-30)."""
    g = 9.80665
    t0 = 288.15
    lr = 0.0065
    crgas = 287.053
    p0 = 101325.0
    out = p0 * torch.pow(
        torch.pow(pressure / p0, (crgas * lr) / g) + (altitude * lr) / t0,
        g / (crgas * lr))
    out = torch.where(pressure == 0, 0.0, out)
    valid = torch.isfinite(altitude) & torch.isfinite(pressure)
    return torch.where(valid | (pressure == 0), out, torch.nan)


def wind_speed(xwind, ywind):
    return torch.sqrt(xwind * xwind + ywind * ywind)


def wind_direction(xwind, ywind):
    """Meteorological wind direction (wind.cpp:21-27)."""
    pi = 3.14159265
    d = torch.atan2(-xwind, -ywind) * 180 / pi
    return torch.where(d < 0, d + 360, d)
