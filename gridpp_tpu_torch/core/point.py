"""Point: a single location (reference gridpp.h:1713-1743, point.cpp)."""
from __future__ import annotations

import numpy as np

from ..constants import MV, CoordinateType
from .coords import convert_coordinates_np


class Point:
    """A single point with lat/lon (or y/x), elevation, land-area fraction.

    Caches ECEF x/y/z like the reference (point.cpp:4-26).
    """

    __slots__ = ("lat", "lon", "elev", "laf", "type", "x", "y", "z")

    def __init__(self, lat, lon, elev=MV, laf=MV,
                 type=CoordinateType.Geodetic, x=None, y=None, z=None):
        self.lat = float(lat)
        self.lon = float(lon)
        self.elev = float(elev)
        self.laf = float(laf)
        self.type = CoordinateType(int(type))
        if x is None or y is None or z is None:
            cx, cy, cz = convert_coordinates_np(self.lat, self.lon, self.type)
            self.x = float(np.asarray(cx))
            self.y = float(np.asarray(cy))
            self.z = float(np.asarray(cz))
        else:
            self.x = float(x)
            self.y = float(y)
            self.z = float(z)

    def __repr__(self):
        return (f"Point(lat={self.lat}, lon={self.lon}, elev={self.elev}, "
                f"laf={self.laf}, type={self.type!r})")
