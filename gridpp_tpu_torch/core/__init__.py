from .grid import Grid
from .point import Point
from .points import Points
from .index import SpatialIndex

__all__ = ["Grid", "Point", "Points", "SpatialIndex"]
