"""Host helpers of the optimal interpolation API (gridpp_tpu/api/oi.py).

Copies of the numpy-only helpers that the serving Pipeline and the
canonical shortlist need: resolved point fields, scale arrays for the
native evaluator, the native kernel id, and the ECEF origin.
"""
from __future__ import annotations

import numpy as np

from ..core.points import Points


def _point_fields(xyz, elevs, lafs, idx=None):
    if idx is None:
        return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "elev": elevs.astype(np.float64),
                "laf": lafs.astype(np.float64)}
    return {"x": xyz[idx, 0], "y": xyz[idx, 1], "z": xyz[idx, 2],
            "elev": elevs[idx].astype(np.float64),
            "laf": lafs[idx].astype(np.float64)}


def _resolved_fields(pts: Points, structure, origin=None) -> dict:
    """Point fields with structure length scales resolved (host).

    When `origin` (an ECEF centroid) is given, coordinates are shifted to
    it and cast to float32: translation leaves all chord distances
    unchanged while restoring full f32 precision near the domain (absolute
    ECEF values ~6.4e6 m would quantize to ~0.5 m steps in f32).
    """
    fields = _point_fields(pts.xyz, pts.elevs, pts.lafs)
    fields["lat"] = pts.lats.astype(np.float64)
    fields["lon"] = pts.lons.astype(np.float64)
    fields = structure.resolve_p1_np(fields)
    fields.pop("lat", None)
    fields.pop("lon", None)
    if origin is not None:
        for i, key in enumerate(("x", "y", "z")):
            fields[key] = (fields[key] - origin[i]).astype(np.float32)
        for key in fields:
            fields[key] = np.asarray(fields[key], np.float32)
    return fields


def _with_scales(fields, structure, count):
    """Field dict + per-point h/v/w arrays (scalar structures broadcast
    their scale attributes) for the native solvers."""
    out = dict(fields)
    for key in ("h", "v", "w"):
        if key not in out:
            out[key] = np.full(count, float(getattr(structure, key, 0.0)),
                               np.float32)
    return out


def _native_kernel_type(structure):
    """Native rho-kernel id for structures the C++ OI solver supports.

    Exact-type match: subclasses may override _corr, and
    Multiple/CrossValidation/Linear have non-product or value-based
    correlation semantics the native kernel does not implement.
    """
    from ..structure import (BarnesStructure, CressmanStructure,
                             PowerlawStructure, SoarStructure,
                             ToarStructure)
    return {BarnesStructure: 0, CressmanStructure: 1, SoarStructure: 2,
            ToarStructure: 3, PowerlawStructure: 4}.get(type(structure))


def _origin(bpoints):
    cached = bpoints.__dict__.get("_origin_cache")
    if cached is None:
        cached = bpoints.xyz.mean(axis=0)
        bpoints.__dict__["_origin_cache"] = cached
    return cached
