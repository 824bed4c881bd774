"""Coordinate conversion and distance metrics.

Host (NumPy, float64) versions, used at precompute time when building
gather-index maps. Semantics follow the reference:

- Geodetic points are embedded on a sphere of radius 6.378137e6 m
  (reference util.cpp:595-615 convert_coordinates).
- All neighbour/radius-query semantics are in CHORD (straight-line 3-D)
  distance, not great-circle (reference kdtree.cpp:192-194).
- `calc_distance` is the great-circle distance (kdtree.cpp:107-133).
"""
from __future__ import annotations

import numpy as np

from ..constants import CoordinateType, radius_earth


def convert_coordinates_np(lats, lons, coordinate_type=CoordinateType.Geodetic):
    """lat/lon (deg) or y/x (m) -> ECEF x,y,z in float64 (util.cpp:595-615)."""
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    if int(coordinate_type) == CoordinateType.Cartesian:
        x = lons.copy()
        y = lats.copy()
        z = np.zeros_like(lats)
    else:
        latr = np.deg2rad(lats)
        lonr = np.deg2rad(lons)
        coslat = np.cos(latr)
        x = coslat * np.cos(lonr) * radius_earth
        y = coslat * np.sin(lonr) * radius_earth
        z = np.sin(latr) * radius_earth
    return x, y, z


def is_valid_lat(lat, coordinate_type=CoordinateType.Geodetic) -> bool:
    lat = np.asarray(lat, dtype=np.float64)
    if int(coordinate_type) == CoordinateType.Cartesian:
        return bool(np.all(np.isfinite(lat)))
    return bool(np.all(np.isfinite(lat) & (lat >= -90.001) & (lat <= 90.001)))


def is_valid_lon(lon, coordinate_type=CoordinateType.Geodetic) -> bool:
    lon = np.asarray(lon, dtype=np.float64)
    return bool(np.all(np.isfinite(lon)))


def calc_distance_np(lat1, lon1, lat2, lon2,
                     coordinate_type=CoordinateType.Geodetic):
    """Great-circle (or Euclidean for Cartesian) distance, kdtree.cpp:107-133."""
    if int(coordinate_type) == CoordinateType.Cartesian:
        dx = np.asarray(lon1, np.float64) - np.asarray(lon2, np.float64)
        dy = np.asarray(lat1, np.float64) - np.asarray(lat2, np.float64)
        return np.sqrt(dx * dx + dy * dy)
    lat1r = np.deg2rad(np.asarray(lat1, np.float64))
    lat2r = np.deg2rad(np.asarray(lat2, np.float64))
    lon1r = np.deg2rad(np.asarray(lon1, np.float64))
    lon2r = np.deg2rad(np.asarray(lon2, np.float64))
    ratio = (np.cos(lat1r) * np.cos(lon1r) * np.cos(lat2r) * np.cos(lon2r)
             + np.cos(lat1r) * np.sin(lon1r) * np.cos(lat2r) * np.sin(lon2r)
             + np.sin(lat1r) * np.sin(lat2r))
    dist = np.arccos(np.clip(ratio, -1.0, 1.0)) * radius_earth
    # exact-match fast path (reference returns 0 before the acos)
    same = (np.asarray(lat1) == np.asarray(lat2)) & (np.asarray(lon1) == np.asarray(lon2))
    return np.where(same, 0.0, dist)


def calc_distance_fast_np(lat1, lon1, lat2, lon2,
                          coordinate_type=CoordinateType.Geodetic):
    """Equirectangular approximation (kdtree.cpp:134-178)."""
    if int(coordinate_type) == CoordinateType.Cartesian:
        dx = np.asarray(lon1, np.float64) - np.asarray(lon2, np.float64)
        dy = np.asarray(lat1, np.float64) - np.asarray(lat2, np.float64)
        return np.sqrt(dx * dx + dy * dy)
    lat1r = np.deg2rad(np.asarray(lat1, np.float64))
    lat2r = np.deg2rad(np.asarray(lat2, np.float64))
    lon1r = np.deg2rad(np.asarray(lon1, np.float64))
    lon2r = np.deg2rad(np.asarray(lon2, np.float64))
    dlon = np.mod(np.abs(lon1r - lon2r), 2 * np.pi)
    dlon = np.where(dlon > np.pi, 2 * np.pi - dlon, dlon)
    max_lat = np.where(np.abs(lat2r) > np.abs(lat1r), lat2r, lat1r)
    dx2 = np.cos(max_lat) ** 2 * dlon * dlon
    dy2 = (lat1r - lat2r) ** 2
    return radius_earth * np.sqrt(dx2 + dy2)


def calc_straight_distance_np(x0, y0, z0, x1, y1, z1):
    """Chord distance in ECEF space (kdtree.cpp:192-194)."""
    dx = np.asarray(x0, np.float64) - np.asarray(x1, np.float64)
    dy = np.asarray(y0, np.float64) - np.asarray(y1, np.float64)
    dz = np.asarray(z0, np.float64) - np.asarray(z1, np.float64)
    return np.sqrt(dx * dx + dy * dy + dz * dz)
