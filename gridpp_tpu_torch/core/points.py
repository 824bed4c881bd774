"""Points: a set of irregular locations (reference points.cpp, gridpp.h:1876).

Host object holding coordinate arrays plus a lazily built SpatialIndex.
Batch query helpers emit the padded gather-index arrays that device kernels
consume.
"""
from __future__ import annotations

import numpy as np

from ..constants import MV, CoordinateType
from . import coords
from .index import SpatialIndex
from .point import Point


def _as1d(x):
    return np.atleast_1d(np.asarray(x, dtype=np.float32))


class Points:
    """A set of scattered points with lats/lons/elevs/lafs (reference
    src/api/points.cpp); missing elevations and land-area fractions are
    filled with NaN like points.cpp:23-30."""

    def __init__(self, lats=(), lons=(), elevs=(), lafs=(),
                 type=CoordinateType.Geodetic):
        lats = _as1d(lats)
        lons = _as1d(lons)
        elevs = _as1d(elevs) if np.size(elevs) else np.zeros(0, np.float32)
        lafs = _as1d(lafs) if np.size(lafs) else np.zeros(0, np.float32)
        n = lats.size
        if lons.size != n:
            raise ValueError(
                "Cannot create points with unequal lat and lon sizes")
        if elevs.size not in (0, n):
            raise ValueError(
                "'elevs' must either be size 0 or the same size at lats/lons")
        if lafs.size not in (0, n):
            raise ValueError(
                "'lafs' must either be size 0 or the same size at lats/lons")
        self._type = CoordinateType(int(type))
        if n and not coords.is_valid_lat(lats, self._type):
            raise ValueError("Invalid latitudes")
        self.lats = lats
        self.lons = lons
        # Missing elevs/lafs are filled with MV (points.cpp:23-30)
        self.elevs = elevs if elevs.size == n else np.full(n, MV, np.float32)
        self.lafs = lafs if lafs.size == n else np.full(n, MV, np.float32)
        self._index: SpatialIndex | None = None

    # -- basic accessors ------------------------------------------------
    def size(self) -> int:
        return int(self.lats.size)

    def __len__(self) -> int:
        return self.size()

    def get_lats(self):
        return self.lats.copy()

    def get_lons(self):
        return self.lons.copy()

    def get_elevs(self):
        return self.elevs.copy()

    def get_lafs(self):
        return self.lafs.copy()

    def get_coordinate_type(self) -> CoordinateType:
        return self._type

    @property
    def index(self) -> SpatialIndex:
        if self._index is None:
            self._index = SpatialIndex(self.lats, self.lons, self._type)
        return self._index

    @property
    def xyz(self) -> np.ndarray:
        return self.index.xyz

    def get_point(self, i: int) -> Point:
        xyz = self.xyz
        return Point(self.lats[i], self.lons[i], self.elevs[i], self.lafs[i],
                     self._type, xyz[i, 0], xyz[i, 1], xyz[i, 2])

    # -- single-point queries (points.cpp:40-61) ------------------------
    def get_nearest_neighbour(self, lat, lon, include_match=True) -> int:
        res = self.get_closest_neighbours(lat, lon, 1, include_match)
        return int(res[0]) if len(res) else -1

    def get_closest_neighbours(self, lat, lon, num, include_match=True):
        if self.size() == 0:
            return np.zeros(0, dtype=np.int32)
        idx, _ = self.index.knearest([lat], [lon], int(num),
                                     include_match=include_match)
        return idx[0][idx[0] >= 0]

    def get_neighbours(self, lat, lon, radius, include_match=True):
        if self.size() == 0:
            return np.zeros(0, dtype=np.int32)
        return self.index.radius_lists([lat], [lon], radius,
                                       include_match=include_match)[0]

    def get_neighbours_with_distance(self, lat, lon, radius,
                                     include_match=True):
        indices = self.get_neighbours(lat, lon, radius, include_match)
        x, y, z = coords.convert_coordinates_np(lat, lon, self._type)
        if len(indices):
            q = np.array([float(np.asarray(x)), float(np.asarray(y)),
                          float(np.asarray(z))])
            d = np.linalg.norm(self.xyz[indices] - q, axis=-1).astype(np.float32)
        else:
            d = np.zeros(0, dtype=np.float32)
        return indices, d

    def get_num_neighbours(self, lat, lon, radius, include_match=True) -> int:
        return int(len(self.get_neighbours(lat, lon, radius, include_match)))

    # -- subsetting (points.cpp:78-150) ---------------------------------
    def get_in_domain_indices(self, grid):
        _, _, _, _, found = grid.get_box_vectorized(self.lats, self.lons)
        return np.nonzero(found)[0].astype(np.int32)

    def get_in_domain(self, grid) -> "Points":
        return self.subset(self.get_in_domain_indices(grid))

    def subset(self, indices) -> "Points":
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size and indices.max() >= self.size():
            raise ValueError(
                f"Index {indices.max()} exceeds number of points {self.size()}")
        return Points(self.lats[indices], self.lons[indices],
                      self.elevs[indices], self.lafs[indices], self._type)
