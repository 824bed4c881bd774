"""Grid: a 2-D curvilinear grid (reference grid.cpp, gridpp.h:1971).

Host object with coordinate arrays, a lazily built flattened SpatialIndex
(row-major, matching grid.cpp:12-55), vectorized get_box (grid.cpp:149-231)
and cached nearest-neighbour gather maps. The gather maps are the TPU-native
replacement for per-cell R-tree lookups: computed once per grid pair, then
every downscaling apply is a pure device gather.
"""
from __future__ import annotations

import numpy as np

from ..constants import MV, CoordinateType
from . import coords
from .index import SpatialIndex
from .point import Point
from .points import Points


def point_in_rectangle_np(alat, alon, blat, blon, clat, clon, dlat, dlon,
                          mlat, mlon):
    """Vectorized cross-product in-rectangle test (util.cpp:571-582).

    Points A,B,C,D must trace the rectangle (either orientation).
    """
    def vect2d(p1lat, p1lon, p2lat, p2lon):
        return -(p2lat - p1lat), (p2lon - p1lon)  # (lat, lon) of the edge

    def dval(vlat, vlon, plat, plon):
        c = -(vlat * plon + vlon * plat)
        return vlat * mlon + vlon * mlat + c

    ab = vect2d(alat, alon, blat, blon)
    ad = vect2d(alat, alon, dlat, dlon)
    bc = vect2d(blat, blon, clat, clon)
    cd = vect2d(clat, clon, dlat, dlon)
    d1 = dval(ab[0], ab[1], alat, alon)
    d2 = dval(ad[0], ad[1], alat, alon)
    d3 = dval(bc[0], bc[1], blat, blon)
    d4 = dval(cd[0], cd[1], clat, clon)
    opt1 = (d1 <= 0) & (d4 <= 0) & (d2 >= 0) & (d3 <= 0)
    opt2 = (d1 >= 0) & (d4 >= 0) & (d2 <= 0) & (d3 >= 0)
    return opt1 | opt2


def _as2d(x):
    arr = np.asarray(x, dtype=np.float32)
    if arr.ndim == 1 and arr.size == 0:
        arr = arr.reshape(0, 0)
    if arr.ndim == 2 and arr.shape[1] == 0:
        arr = arr.reshape(0, 0)
    if arr.ndim != 2:
        raise ValueError("Grid coordinates must be 2D")
    return arr


class Grid:
    """2-D curvilinear grid of lat/lon (or y/x) coordinates with optional
    elevations and land-area fractions (reference src/api/grid.cpp).

    Spatial queries run in chord (straight-line 3-D) distance like the
    reference KDTree; nearest/bilinear gather maps are precomputed on
    the host and cached per target object for the device apply step."""

    def __init__(self, lats=((),), lons=((),), elevs=(), lafs=(),
                 type=CoordinateType.Geodetic):
        lats = _as2d(lats)
        lons = _as2d(lons)
        if lats.shape != lons.shape:
            raise ValueError("Grid lat and lon sizes are not identical")
        self._type = CoordinateType(int(type))
        if lats.size and not coords.is_valid_lat(lats, self._type):
            raise ValueError("Invalid latitudes")
        self.lats = lats
        self.lons = lons
        ny, nx = lats.shape
        elevs = np.asarray(elevs, dtype=np.float32) if np.size(elevs) else None
        lafs = np.asarray(lafs, dtype=np.float32) if np.size(lafs) else None
        # Missing/mis-sized elevs and lafs filled with MV (grid.cpp:41-55)
        self.elevs = (elevs if elevs is not None and elevs.shape == lats.shape
                      else np.full((ny, nx), MV, np.float32))
        self.lafs = (lafs if lafs is not None and lafs.shape == lats.shape
                     else np.full((ny, nx), MV, np.float32))
        self._index: SpatialIndex | None = None
        import weakref
        self._map_cache = weakref.WeakKeyDictionary()

    # -- basic accessors ------------------------------------------------
    def size(self):
        if self.lats.size == 0:
            return [0, 0]
        return [int(self.lats.shape[0]), int(self.lats.shape[1])]

    @property
    def shape(self):
        return self.lats.shape

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

    def get_2d(self, values):
        values = np.asarray(values)
        nx = self.lats.shape[1]
        return values.reshape(-1, nx)

    @property
    def index(self) -> SpatialIndex:
        if self._index is None:
            self._index = SpatialIndex(self.lats.ravel(), self.lons.ravel(),
                                       self._type)
        return self._index

    def to_points(self) -> Points:
        # Cached: grids are immutable in practice and the flattened Points
        # (with its spatial index and candidate caches) is reused by every
        # OI call on the same grid.
        cached = getattr(self, "_points_cache", None)
        if cached is None:
            cached = Points(self.lats.ravel(), self.lons.ravel(),
                            self.elevs.ravel(), self.lafs.ravel(), self._type)
            cached._index = self._index  # share the flattened index if built
            self._points_cache = cached
        return cached

    def get_point(self, y: int, x: int) -> Point:
        i = y * self.lats.shape[1] + x
        xyz = self.index.xyz
        return Point(self.lats[y, x], self.lons[y, x], self.elevs[y, x],
                     self.lafs[y, x], self._type,
                     xyz[i, 0], xyz[i, 1], xyz[i, 2])

    def _unflatten(self, flat):
        nx = self.lats.shape[1]
        flat = np.asarray(flat)
        return np.stack([flat // nx, flat % nx], axis=-1).astype(np.int32)

    # -- single-point queries (grid.cpp:57-85) --------------------------
    def get_nearest_neighbour(self, lat, lon, include_match=True):
        res = self.get_closest_neighbours(lat, lon, 1, include_match)
        return res[0] if len(res) else np.zeros(0, dtype=np.int32)

    def get_closest_neighbours(self, lat, lon, num, include_match=True):
        if self.lats.size == 0:
            return np.zeros((0, 2), dtype=np.int32)
        idx, _ = self.index.knearest([lat], [lon], int(num),
                                     include_match=include_match)
        flat = idx[0][idx[0] >= 0]
        return self._unflatten(flat)

    def get_neighbours(self, lat, lon, radius, include_match=True):
        if self.lats.size == 0:
            return np.zeros((0, 2), dtype=np.int32)
        flat = self.index.radius_lists([lat], [lon], radius,
                                       include_match=include_match)[0]
        return self._unflatten(flat)

    def get_neighbours_with_distance(self, lat, lon, radius,
                                     include_match=True):
        flat = self.index.radius_lists([lat], [lon], radius,
                                       include_match=include_match)[0]
        x, y, z = coords.convert_coordinates_np(lat, lon, self._type)
        q = np.array([float(np.asarray(x)), float(np.asarray(y)),
                      float(np.asarray(z))])
        d = (np.linalg.norm(self.index.xyz[flat] - q, axis=-1).astype(np.float32)
             if len(flat) else np.zeros(0, np.float32))
        return self._unflatten(flat), d

    def get_num_neighbours(self, lat, lon, radius, include_match=True) -> int:
        if self.lats.size == 0:
            return 0
        return int(len(self.index.radius_lists([lat], [lon], radius,
                                               include_match=include_match)[0]))

    # -- precompute maps -------------------------------------------------
    def nearest_map(self, qlats, qlons, cache_obj=None) -> np.ndarray:
        """Flattened nearest-gridpoint index for each query point.

        This is the gather map that replaces the reference's per-cell
        R-tree lookup (nearest.cpp:46-69). When cache_obj (the target
        Grid/Points object) is given, the map is cached weakly per target.
        """
        if cache_obj is not None:
            try:
                return self._map_cache[cache_obj]
            except (KeyError, TypeError):
                pass
        qlats = np.asarray(qlats, dtype=np.float64).ravel()
        qlons = np.asarray(qlons, dtype=np.float64).ravel()
        flat = self.index.nearest(qlats, qlons)
        if cache_obj is not None:
            try:
                self._map_cache[cache_obj] = flat
            except TypeError:
                pass
        return flat

    def get_box_vectorized(self, qlats, qlons):
        """Vectorized Grid::get_box (grid.cpp:149-231).

        For each query point, finds the enclosing grid cell via the nearest
        gridpoint plus a 4-quadrant in-rectangle test, in the same quadrant
        order as the reference: (x-1,y+1), (x+1,y+1), (x-1,y-1), (x+1,y-1).
        Returns (Y1, X1, Y2, X2, found) int32/bool arrays.
        """
        qlats = np.asarray(qlats, dtype=np.float64).ravel()
        qlons = np.asarray(qlons, dtype=np.float64).ravel()
        n = qlats.size
        ny, nx = self.lats.shape if self.lats.size else (0, 0)
        y1 = np.full(n, -1, np.int32)
        x1 = np.full(n, -1, np.int32)
        y2 = np.full(n, -1, np.int32)
        x2 = np.full(n, -1, np.int32)
        found = np.zeros(n, bool)
        if ny <= 1 or nx <= 1 or n == 0:
            return y1, x1, y2, x2, found
        flat = self.nearest_map(qlats, qlons)
        yy = (flat // nx).astype(np.int64)
        xx = (flat % nx).astype(np.int64)
        lats = self.lats.astype(np.float64)
        lons = self.lons.astype(np.float64)

        remaining = np.ones(n, bool)
        sel_xdir = np.zeros(n, np.int64)
        sel_ydir = np.zeros(n, np.int64)
        # Quadrant order matches grid.cpp:184-210: it=0..3 ->
        # (xdir,ydir) = (-1,+1), (+1,+1), (-1,-1), (+1,-1)
        for xdir, ydir in ((-1, 1), (1, 1), (-1, -1), (1, -1)):
            ok = remaining.copy()
            if ydir == -1:
                ok &= yy != 0
            else:
                ok &= yy != ny - 1
            if xdir == -1:
                ok &= xx != 0
            else:
                ok &= xx != nx - 1
            if not ok.any():
                continue
            ys = yy[ok]
            xs = xx[ok]
            inr = point_in_rectangle_np(
                lats[ys, xs], lons[ys, xs],
                lats[ys + ydir, xs], lons[ys + ydir, xs],
                lats[ys + ydir, xs + xdir], lons[ys + ydir, xs + xdir],
                lats[ys, xs + xdir], lons[ys, xs + xdir],
                qlats[ok], qlons[ok])
            hit = np.zeros(n, bool)
            hit[np.nonzero(ok)[0][inr]] = True
            sel_xdir[hit] = xdir
            sel_ydir[hit] = ydir
            found |= hit
            remaining &= ~hit
        fy = found
        y1[fy] = np.where(sel_ydir[fy] == 1, yy[fy], yy[fy] - 1)
        y2[fy] = np.where(sel_ydir[fy] == 1, yy[fy] + 1, yy[fy])
        x1[fy] = np.where(sel_xdir[fy] == 1, xx[fy], xx[fy] - 1)
        x2[fy] = np.where(sel_xdir[fy] == 1, xx[fy] + 1, xx[fy])
        return y1, x1, y2, x2, found

    def get_box(self, lat, lon):
        """Single-point get_box; returns (found, Y1, X1, Y2, X2)."""
        y1, x1, y2, x2, found = self.get_box_vectorized([lat], [lon])
        return bool(found[0]), int(y1[0]), int(x1[0]), int(y2[0]), int(x2[0])
