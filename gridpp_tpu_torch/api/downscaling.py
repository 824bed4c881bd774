"""Downscaling API: nearest, bilinear and the downscaling dispatch
(gridpp_tpu/api/downscaling.py; reference src/api/{nearest,bilinear,
downscaling}.cpp).

Grid -> Grid, Grid -> Points, Points -> Grid and Points -> Points, 2-D
and 3-D (a leading time axis), dispatched on the argument types as the
SWIG overloads are. numpy in, numpy out. The gathers run on the API's
device, read once per call (api/_common.api_device): the host pins it to
the CPU, and a module function called unpinned runs its gathers on the
card. A source's index maps to a target are built once on the host and
cached weakly per target, with their tensors beside them per device, so a
card call uploads its map once (about 116 MB for a 2000 x 2000 target)
and then only gathers.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..constants import MV, Downscaler
from ..core.bilinear_weights import BilinearMap, compute_bilinear_map
from ..core.grid import Grid
from ..core.points import Points
from ..ops import downscaling as ops
from ._common import (api_device, asarray_f32, check_grid_compatible,
                      check_points_compatible, upload)

__all__ = ["nearest", "bilinear", "downscaling"]


def _target_latlon(target):
    if isinstance(target, Grid):
        return target.lats, target.lons, target.lats.shape
    return target.lats, target.lons, (target.size(),)


def _maps(source, target) -> dict:
    """source's maps to target: one dict cached weakly per target (a fresh
    one for a target that cannot be weakly referenced), holding each host
    map under its kind and its tensors under (kind, device)."""
    cache = source.__dict__.setdefault("_downscale_maps",
                                       weakref.WeakKeyDictionary())
    try:
        return cache.setdefault(target, {})
    except TypeError:
        return {}


def _map_tensors(source, kind, target, dev, build):
    """The tensors on dev of source's `kind` map to target: build() (a
    tuple of host arrays) runs once per target and is uploaded once per
    device."""
    maps = _maps(source, target)
    if kind not in maps:
        maps[kind] = build()
    if (kind, dev) not in maps:
        maps[kind, dev] = tuple(torch.as_tensor(a, device=dev)
                                for a in maps[kind])
    return maps[kind, dev]


def _bilinear_map(igrid: Grid, target) -> BilinearMap:
    """igrid's BilinearMap to target, built on the host once per target."""
    maps = _maps(igrid, target)
    if "bilinear map" not in maps:
        lats, lons, _ = _target_latlon(target)
        maps["bilinear map"] = compute_bilinear_map(igrid, lats, lons)
    return maps["bilinear map"]


def downscale_tensor(source, target, values: torch.Tensor,
                     downscaler) -> torch.Tensor:
    """Downscale a tensor of values on source to target, on the values'
    device: (..., Y, X) on a Grid or (..., P) on Points to (..., *target
    shape). Validates as the numpy API does."""
    downscaler = int(downscaler)
    if downscaler == Downscaler.Nearest:
        return _nearest(source, target, values)
    if downscaler == Downscaler.Bilinear:
        return _bilinear(source, target, values)
    raise ValueError("Invalid downscaler")


def _nearest(source, target, values):
    qlats, qlons, oshape = _target_latlon(target)
    dev = values.device
    if isinstance(source, Grid):
        if values.dim() not in (2, 3):
            raise ValueError("values must be 2D or 3D")
        check_grid_compatible(source, values)
        if source.size()[0] == 0 or source.size()[1] == 0:
            return torch.full(values.shape[:-2] + oshape, MV, device=dev)
        (flat,) = _map_tensors(source, "nearest", target, dev, lambda: (
            source.nearest_map(qlats, qlons),))
    elif isinstance(source, Points):
        if values.dim() not in (1, 2):
            raise ValueError("values must be 1D or 2D")
        check_points_compatible(source, values)
        if source.size() == 0:
            return torch.full(values.shape[:-1] + oshape, MV, device=dev)
        (flat,) = _map_tensors(source, "nearest", target, dev, lambda: (
            source.index.nearest(np.asarray(qlats, np.float64).ravel(),
                                 np.asarray(qlons, np.float64).ravel()),))
        # Points values are flat already: (..., P) as (..., 1, P) for the
        # shared gather
        values = values[..., None, :]
    else:
        raise ValueError("source must be a Grid or Points")
    out = ops.nearest_apply(values, flat)
    return out.reshape(values.shape[:-2] + oshape)


def _bilinear(igrid, target, values):
    if not isinstance(igrid, Grid):
        raise ValueError("Bilinear interpolation requires a Grid source")
    if values.dim() not in (2, 3):
        raise ValueError("values must be 2D or 3D")
    check_grid_compatible(igrid, values)
    _, _, oshape = _target_latlon(target)
    if igrid.size()[0] == 0 or igrid.size()[1] == 0:
        return torch.full(values.shape[:-2] + oshape, MV,
                          device=values.device)

    def build():
        m = _bilinear_map(igrid, target)
        return m.p1, m.p2, m.p3, m.p4, m.nn, m.s, m.t, m.inside

    maps = _map_tensors(igrid, "bilinear", target, values.device, build)
    out = ops.bilinear_apply(values, *maps)
    return out.reshape(values.shape[:-2] + oshape)


def _numpy_call(source, target, ivalues, downscaler):
    ivalues = asarray_f32(ivalues)
    out = downscale_tensor(source, target, upload(ivalues, api_device()),
                           downscaler)
    return out.cpu().numpy()


def nearest(source, target, ivalues):
    """Nearest-neighbour downscale or interpolation (nearest.cpp).

    (Grid, Grid, (Y,X)) -> (Yo,Xo);  (Grid, Grid, (T,Y,X)) -> (T,Yo,Xo)
    (Grid, Points, (Y,X)) -> (P,);   (Grid, Points, (T,Y,X)) -> (T,P)
    (Points, Points, (P,)) -> (Po,); (Points, Points, (T,P)) -> (T,Po)
    (Points, Grid, (P,)) -> (Y,X);   (Points, Grid, (T,P)) -> (T,Y,X)
    """
    return _numpy_call(source, target, ivalues, Downscaler.Nearest)


def bilinear(igrid, target, ivalues):
    """Bilinear downscale or interpolation from a Grid (bilinear.cpp)."""
    return _numpy_call(igrid, target, ivalues, Downscaler.Bilinear)


def downscaling(igrid, target, ivalues, downscaler):
    """Dispatch on the Downscaler enum (downscaling.cpp:7-61)."""
    if int(downscaler) not in (Downscaler.Nearest, Downscaler.Bilinear):
        raise ValueError("Invalid downscaler")
    return _numpy_call(igrid, target, ivalues, downscaler)
