"""User-facing KDTree (gridpp_tpu/core/kdtree.py; reference gridpp.h:
1746-1872, kdtree.cpp).

A host facade over SpatialIndex, kept for API parity: the port's operators
query no tree at apply time (they gather through precomputed maps), but
user code written against gridpp's bindings may use KDTree directly.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import CoordinateType
from . import coords
from .index import SpatialIndex
from .point import Point


class KDTree:
    """Spatial index over ECEF coordinates (reference src/api/kdtree.cpp, a
    boost R-tree there; the native cell-hash index or scipy's cKDTree
    here). All radius and nearest semantics are in chord distance
    (kdtree.cpp:192-194)."""

    def __init__(self, lats=(), lons=(), type=CoordinateType.Geodetic):
        lats = np.atleast_1d(np.asarray(lats, dtype=np.float64))
        lons = np.atleast_1d(np.asarray(lons, dtype=np.float64))
        self._type = CoordinateType(int(type))
        if lats.size and not coords.is_valid_lat(lats, self._type):
            raise ValueError("Invalid latitudes")
        self._index = SpatialIndex(lats, lons, self._type) if lats.size \
            else None
        self._lats = lats
        self._lons = lons

    # -- queries (kdtree.cpp:18-106) ------------------------------------
    def size(self) -> int:
        return int(self._lats.size)

    def get_lats(self):
        return self._lats.copy()

    def get_lons(self):
        return self._lons.copy()

    def get_x(self):
        return self._index.xyz[:, 0].copy() if self._index else np.zeros(0)

    def get_y(self):
        return self._index.xyz[:, 1].copy() if self._index else np.zeros(0)

    def get_z(self):
        return self._index.xyz[:, 2].copy() if self._index else np.zeros(0)

    def get_coordinate_type(self) -> CoordinateType:
        return self._type

    def get_nearest_neighbour(self, lat, lon, include_match=True) -> int:
        res = self.get_closest_neighbours(lat, lon, 1, include_match)
        return int(res[0]) if len(res) else -1

    def get_closest_neighbours(self, lat, lon, num, include_match=True):
        if self._index is None:
            return np.zeros(0, dtype=np.int32)
        idx, _ = self._index.knearest([lat], [lon], int(num),
                                      include_match=include_match)
        return idx[0][idx[0] >= 0]

    def get_neighbours(self, lat, lon, radius, include_match=True):
        if self._index is None:
            return np.zeros(0, dtype=np.int32)
        return self._index.radius_lists([lat], [lon], radius,
                                        include_match=include_match)[0]

    def get_neighbours_with_distance(self, lat, lon, radius,
                                     include_match=True):
        indices = self.get_neighbours(lat, lon, radius, include_match)
        x, y, z = coords.convert_coordinates_np(lat, lon, self._type)
        q = np.stack([np.atleast_1d(x), np.atleast_1d(y),
                      np.atleast_1d(z)], axis=-1)
        d = np.linalg.norm(self._index.xyz[indices] - q, axis=-1).astype(
            np.float32) if len(indices) else np.zeros(0, dtype=np.float32)
        return indices, d

    def get_num_neighbours(self, lat, lon, radius, include_match=True) -> int:
        return int(len(self.get_neighbours(lat, lon, radius, include_match)))

    # -- static distance helpers (kdtree.cpp:107-200) -------------------
    @staticmethod
    def calc_distance(*args):
        """calc_distance(lat1, lon1, lat2, lon2[, type]) or (p1, p2)."""
        if len(args) == 2 and isinstance(args[0], Point):
            p1, p2 = args
            if p1.type != p2.type:
                raise ValueError("Coordinate types must be the same")
            return float(coords.calc_distance_np(
                p1.lat, p1.lon, p2.lat, p2.lon, p1.type))
        lat1, lon1, lat2, lon2 = args[:4]
        ctype = args[4] if len(args) > 4 else CoordinateType.Geodetic
        return float(coords.calc_distance_np(lat1, lon1, lat2, lon2, ctype))

    @staticmethod
    def calc_distance_fast(lat1, lon1, lat2, lon2,
                           type=CoordinateType.Geodetic):
        return float(coords.calc_distance_fast_np(lat1, lon1, lat2, lon2,
                                                  type))

    @staticmethod
    def calc_straight_distance(*args):
        """calc_straight_distance(p1, p2) or (x0, y0, z0, x1, y1, z1)."""
        if len(args) == 2 and isinstance(args[0], Point):
            p1, p2 = args
            return float(coords.calc_straight_distance_np(
                p1.x, p1.y, p1.z, p2.x, p2.y, p2.z))
        x0, y0, z0, x1, y1, z1 = args
        return float(coords.calc_straight_distance_np(x0, y0, z0, x1, y1, z1))

    @staticmethod
    def deg2rad(deg):
        return float(deg) * math.pi / 180.0

    @staticmethod
    def rad2deg(rad):
        return float(rad) * 180.0 / math.pi
