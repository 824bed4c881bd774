"""Coordinates, the nearest gridpoint and the rho shortlist (reference).

gridpp keeps latitudes and longitudes as float32 and measures distance as
the chord between points on a sphere of radius 6.378137e6 m
(util.cpp convert_coordinates, kdtree.cpp calc_straight_distance). Here the
float32 coordinates are embedded in float64 and every distance is float64.

Barnes rho (structure.cpp): exp(-0.5 (d / h)^2) for d <= the localization
distance sqrt(-2 ln min_rho) h with gridpp's default min_rho 0.0013,
else 0. A gridpoint's stations are ranked by rho, highest first, the lower
station index first on an exact tie (oi.cpp's selection).
"""
from __future__ import annotations

import math

import numpy as np
import torch

RADIUS_EARTH = 6.378137e6   # gridpp.h radius_earth
MIN_RHO = 0.0013            # gridpp.h default_min_rho
PAIRS_PER_BLOCK = 1 << 25   # gridpoint x station pairs held at once


def xyz(lats, lons) -> np.ndarray:
    """(..., 3) float64 Earth-centred coordinates of float32 lat/lon."""
    lat = np.radians(np.asarray(lats, np.float32).astype(np.float64))
    lon = np.radians(np.asarray(lons, np.float32).astype(np.float64))
    return np.stack([np.cos(lat) * np.cos(lon) * RADIUS_EARTH,
                     np.cos(lat) * np.sin(lon) * RADIUS_EARTH,
                     np.sin(lat) * RADIUS_EARTH], axis=-1)


def localization(h: float) -> float:
    """Barnes localization distance (m) of length scale h."""
    return math.sqrt(-2.0 * math.log(MIN_RHO)) * h


def barnes(d2, h: float, loc: float):
    """Barnes rho of squared distances d2 (tensor), 0 beyond loc."""
    return torch.where(d2 <= loc * loc, torch.exp(-0.5 * d2 / (h * h)),
                       torch.zeros((), dtype=d2.dtype, device=d2.device))


def product_axes(lats, lons):
    """(row lats (Y,), column lons (X,)) of a grid whose latitude is
    constant along rows and longitude along columns; raises otherwise."""
    lats = np.asarray(lats, np.float32)
    lons = np.asarray(lons, np.float32)
    if not ((lats == lats[:, :1]).all() and (lons == lons[:1, :]).all()):
        raise ValueError("the reference takes a regular lat/lon grid")
    return lats[:, 0], lons[0, :]


def _axis_window(axis, q, reach):
    """Indices (len(q), 2 reach + 1) of the axis values around q, clipped."""
    n = axis.shape[0]
    up = axis[-1] >= axis[0]
    i = np.searchsorted(axis if up else axis[::-1], q)
    if not up:
        i = n - i
    off = np.arange(-reach, reach + 1)
    return np.clip(i[:, None] + off[None, :], 0, n - 1)


def nearest(lats, lons, plats, plons, reach: int = 2) -> np.ndarray:
    """Flat index of each station's nearest gridpoint by chord distance,
    the lower index on an exact tie. On a regular grid the nearest lies
    within `reach` rows and columns of where the station falls."""
    glat, glon = product_axes(lats, lons)
    nx = glon.shape[0]
    rows = _axis_window(glat, np.asarray(plats, np.float32), reach)
    cols = _axis_window(glon, np.asarray(plons, np.float32), reach)
    flat = (rows[:, :, None] * nx + cols[:, None, :]).reshape(len(rows), -1)
    flat = np.sort(flat, axis=1)
    g = xyz(glat[flat // nx], glon[flat % nx])
    s = xyz(plats, plons)[:, None, :]
    d2 = ((g - s) ** 2).sum(axis=-1)
    return flat[np.arange(len(flat)), np.argmin(d2, axis=1)]


def ranked(lats, lons, plats, plons, h: float, k: int, device,
           ok=None, rows=None):
    """Every gridpoint's k stations of highest rho, ranked.

    lats, lons: (Y, X) grid; plats, plons: (P,) stations; ok: (P,) bool of
    the stations to rank (all by default); rows: flat gridpoint indices to
    rank (all by default). Returns (sel (M, k) int64 station ids, -1 where
    fewer than k stations are in range; rho (M, k) float64, 0 there), on
    `device`. Stations are taken from a latitude band around each block of
    gridpoints that holds every station within the localization distance.
    """
    glat, glon = product_axes(lats, lons)
    ny, nx = glat.shape[0], glon.shape[0]
    loc = localization(h)
    reach = math.degrees(2 * math.asin(min(1.0, loc / (2 * RADIUS_EARTH))))
    reach += 1e-6
    plat = np.asarray(plats, np.float32).astype(np.float64)
    ok = np.ones(plat.shape, bool) if ok is None else np.asarray(ok, bool)
    sxyz = torch.as_tensor(xyz(plats, plons), device=device)
    if rows is None:
        rows = np.arange(ny * nx)
    rows = np.asarray(rows, np.int64)
    sel = torch.full((len(rows), k), -1, dtype=torch.int64, device=device)
    rho = torch.zeros((len(rows), k), dtype=torch.float64, device=device)
    start, size = 0, len(rows)
    while start < len(rows):
        # a block of gridpoints and the stations of its latitude band, the
        # block halved until it holds at most PAIRS_PER_BLOCK pairs
        while True:
            r = rows[start:start + size]
            lat_r = glat[r // nx].astype(np.float64)
            cand = np.nonzero(ok & (plat >= lat_r.min() - reach)
                              & (plat <= lat_r.max() + reach))[0]
            if size == 1 or len(r) * cand.size <= PAIRS_PER_BLOCK:
                break
            size //= 2
        size = len(r)
        g = torch.as_tensor(xyz(glat[r // nx], glon[r % nx]), device=device)
        if cand.size:
            c = torch.as_tensor(cand, device=device)
            d2 = ((g[:, None, :] - sxyz[c][None, :, :]) ** 2).sum(-1)
            rr = torch.where(d2 <= loc * loc,
                             torch.exp(-0.5 * d2 / (h * h)),
                             torch.full((), -1.0, dtype=torch.float64,
                                        device=device))
            kk = min(k, cand.size)
            val, pos = torch.topk(rr, kk, dim=1)
            ids = c[pos]
            # the lower id first among equal rho: sort by id, then stably
            # by rho
            ids, order = torch.sort(ids, dim=1)
            val = torch.gather(val, 1, order)
            val, order = torch.sort(val, dim=1, descending=True, stable=True)
            ids = torch.gather(ids, 1, order)
            live = val > 0
            sel[start:start + size, :kk] = torch.where(live, ids, -1)
            rho[start:start + size, :kk] = torch.where(live, val, 0.0)
        start += size
    return sel, rho


def first_valid(sel, rho, ok, s: int):
    """The first s stations of each ranked row that `ok` (P,) bool tensor
    admits, and the next one after them. Returns (sel (M, s + 1), rho
    (M, s + 1), short (M,) bool: rows whose ranking ran out of admitted
    stations before s + 1 while it was full, so that a deeper ranking is
    needed)."""
    adm = (sel >= 0) & ok[sel.clamp(min=0)]
    rank = torch.cumsum(adm.to(torch.int64), dim=1) - 1
    keep = adm & (rank <= s)
    m, k = sel.shape
    out_sel = torch.full((m, s + 1), -1, dtype=sel.dtype, device=sel.device)
    out_rho = torch.zeros((m, s + 1), dtype=rho.dtype, device=rho.device)
    r_idx, c_idx = torch.nonzero(keep, as_tuple=True)
    out_sel[r_idx, rank[r_idx, c_idx]] = sel[r_idx, c_idx]
    out_rho[r_idx, rank[r_idx, c_idx]] = rho[r_idx, c_idx]
    short = (adm.sum(dim=1) < s + 1) & (sel[:, -1] >= 0)
    return out_sel, out_rho, short
