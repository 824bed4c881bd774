"""Host-side spatial index used at precompute time.

The reference wraps a boost R-tree (reference src/api/kdtree.cpp) and
queries it per gridpoint inside every operator's hot loop. The TPU design
moves ALL spatial queries to a one-time host precompute that emits dense
gather-index/mask arrays; apply time is pure gathers on device. This module
is that precompute engine.

Backend: scipy.spatial.cKDTree over float64 ECEF coordinates (chord-distance
semantics identical to the reference, kdtree.cpp:39-103). A native C++
backend can be slotted in behind the same interface for faster builds.

Query semantics (match kdtree.cpp):
- radius queries are inclusive (dist <= radius)
- include_match=False drops points at chord distance exactly 0
- k-nearest returns results sorted by distance
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..constants import CoordinateType
from .coords import convert_coordinates_np


class SpatialIndex:
    """k-NN / radius index over a fixed set of points in ECEF space."""

    def __init__(self, lats, lons, coordinate_type=CoordinateType.Geodetic):
        lats = np.atleast_1d(np.asarray(lats, dtype=np.float64))
        lons = np.atleast_1d(np.asarray(lons, dtype=np.float64))
        if lats.shape != lons.shape:
            raise ValueError("Latitudes and longitudes must have the same size")
        self.lats = lats
        self.lons = lons
        self.coordinate_type = CoordinateType(int(coordinate_type))
        x, y, z = convert_coordinates_np(lats, lons, coordinate_type)
        self.xyz = np.stack([x, y, z], axis=-1)
        self._tree = None
        self._native = None
        self._native_tried = False

    @property
    def tree(self) -> cKDTree:
        if self._tree is None:
            if self.xyz.shape[0] == 0:
                raise ValueError("Empty index")
            self._tree = cKDTree(self.xyz)
        return self._tree

    def __len__(self) -> int:
        return self.xyz.shape[0]

    def _query_xyz(self, qlats, qlons):
        x, y, z = convert_coordinates_np(qlats, qlons, self.coordinate_type)
        return np.stack([np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(z)],
                        axis=-1)

    @property
    def native(self):
        """The C++ cell-hash engine, or None (scipy fallback)."""
        if not self._native_tried:
            self._native_tried = True
            if self.xyz.shape[0] > 0:
                try:
                    from ..native import NativeIndex
                    self._native = NativeIndex(self.xyz)
                except Exception:
                    self._native = None
        return self._native

    def nearest(self, qlats, qlons) -> np.ndarray:
        """Index of the nearest point for each query (kdtree.cpp:104-106)."""
        q = self._query_xyz(qlats, qlons)
        native = self.native
        if native is not None:
            return native.nearest(q)
        _, idx = self.tree.query(q, k=1, workers=-1)
        return np.atleast_1d(idx).astype(np.int32)

    def knearest(self, qlats, qlons, k: int, include_match: bool = True):
        """(indices, distances) of the k nearest points, sorted by distance.

        Returns arrays of shape (N, k); when fewer than k points exist the
        tail is filled with index -1 / distance inf.
        """
        q = self._query_xyz(qlats, qlons)
        n_avail = len(self)
        kq = min(k + (0 if include_match else 1), n_avail)
        native = self.native
        if native is not None:
            idx, dist = native.knearest(q, kq)
        else:
            dist, idx = self.tree.query(q, k=kq, workers=-1)
        dist = np.atleast_2d(dist)
        idx = np.atleast_2d(idx)
        if not include_match:
            # Drop entries at chord distance exactly 0 (kdtree.cpp:88-92):
            # stable-sort kept entries to the front of each row, then trim
            keep = (dist != 0) & np.isfinite(dist)
            order = np.argsort(~keep, axis=1, kind="stable")
            idx2 = np.take_along_axis(idx, order, axis=1)[:, :k]
            dist2 = np.take_along_axis(dist, order, axis=1)[:, :k]
            kept2 = np.take_along_axis(keep, order, axis=1)[:, :k]
            idx = np.where(kept2, idx2, -1).astype(np.int64)
            dist = np.where(kept2, dist2, np.inf)
        elif kq < k:
            pad_i = np.full((q.shape[0], k - kq), -1, dtype=idx.dtype)
            pad_d = np.full((q.shape[0], k - kq), np.inf)
            idx = np.concatenate([idx, pad_i], axis=1)
            dist = np.concatenate([dist, pad_d], axis=1)
        return idx.astype(np.int32), dist

    def radius_lists(self, qlats, qlons, radius: float,
                     include_match: bool = True):
        """List-of-arrays radius query (kdtree.cpp:39-80).

        Reference semantics: dist <= radius AND strictly inside the
        bounding box [q-r, q+r]^3 - boost's `within(box)` prefilter is
        boundary-exclusive, so a point exactly `radius` away ALONG AN
        AXIS is dropped (the reference's own test_radius_match asserts
        this for Cartesian points).
        """
        q = self._query_xyz(qlats, qlons)
        res = self.tree.query_ball_point(q, r=float(radius), workers=-1)
        out = []
        for i, lst in enumerate(res):
            arr = np.asarray(lst, dtype=np.int32)
            if arr.size:
                diff = self.xyz[arr] - q[i]
                inside_box = np.max(np.abs(diff), axis=-1) < radius
                if not include_match:
                    d = np.linalg.norm(diff, axis=-1)
                    inside_box &= d != 0
                arr = arr[inside_box]
            out.append(arr)
        return out

    def radius_counts(self, qlats, qlons, radius: float) -> np.ndarray:
        """Number of points within chord radius of each query."""
        q = self._query_xyz(qlats, qlons)
        native = self.native
        if native is not None:
            return native.radius_count(q, float(radius))
        return np.asarray(
            self.tree.query_ball_point(q, r=float(radius), workers=-1,
                                       return_length=True),
            dtype=np.int32)

    def radius_padded(self, qlats, qlons, radius: float, max_k: int = 0):
        """Padded radius query: (indices[N,K], distances[N,K], counts[N]).

        K = max observed neighbour count (or max_k cap if given, keeping the
        CLOSEST max_k — callers that need top-by-rho selection should pass
        max_k=0 and select themselves). Padding: index -1, distance inf.
        """
        q = self._query_xyz(qlats, qlons)
        lists = self.tree.query_ball_point(q, r=float(radius), workers=-1)
        counts = np.fromiter((len(l) for l in lists), dtype=np.int32,
                             count=len(lists))
        kmax = int(counts.max()) if counts.size else 0
        if max_k > 0:
            kmax = min(kmax, int(max_k))
        kmax = max(kmax, 1)
        idx = np.full((q.shape[0], kmax), -1, dtype=np.int32)
        dist = np.full((q.shape[0], kmax), np.inf)
        for i, lst in enumerate(lists):
            if not lst:
                continue
            arr = np.asarray(lst, dtype=np.int32)
            d = np.linalg.norm(self.xyz[arr] - q[i], axis=-1)
            if arr.size > kmax:
                sel = np.argsort(d, kind="stable")[:kmax]
                arr = arr[sel]
                d = d[sel]
            idx[i, :arr.size] = arr
            dist[i, :arr.size] = d
        counts = np.minimum(counts, kmax)
        return idx, dist, counts
