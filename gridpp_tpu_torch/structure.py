"""Structure functions (reference src/api/structure.cpp, gridpp.h:2069-2343).

A copy of gridpp_tpu.structure whose device facade is torch instead of
jax.numpy. Each structure provides:
- the gridpp-parity host API: corr(p1, p2[s]), corr_background,
  localization_distance on Point objects;
- a vectorized device API used by the OI code: `corr_torch(p1, p2)` over
  field dicts of tensors (x, y, z, elev, laf [, h, v, w]), broadcasting so
  one call evaluates a whole (gridpoints x neighbours) or (obs x obs) block;
- host helpers `localization_np(lats, lons)` and `resolve_hvw_np` that
  resolve per-point length scales (spatially varying structures look the
  scales up on their scale grid via nearest neighbour, structure.cpp:188-213).

Correlation semantics match the reference: product of horizontal x
vertical(elev) x laf kernels; elev/laf factors are skipped when either
point's value is missing; points beyond the localization distance get 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .constants import MV
from .core.point import Point

__all__ = [
    "StructureFunction", "MultipleStructure", "BarnesStructure",
    "CressmanStructure", "SoarStructure", "ToarStructure",
    "PowerlawStructure", "LinearStructure", "CrossValidation",
]


# ---------------------------------------------------------------------------
# rho kernels (structure.cpp:26-87), written for both numpy and torch inputs
# ---------------------------------------------------------------------------
def _barnes_rho(xp, dist, length):
    disabled = ~xp.isfinite(length) | (length == 0)
    v = dist / xp.where(length == 0, 1, length)
    rho = xp.exp(-0.5 * v * v)
    rho = xp.where(xp.isfinite(dist), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


def _cressman_rho(xp, dist, length):
    disabled = ~xp.isfinite(length) | (length == 0)
    ll = xp.where(length == 0, 1, length)
    rho = xp.where(xp.abs(dist) >= xp.abs(length), 0.0,
                   (ll * ll - dist * dist) / (ll * ll + dist * dist))
    rho = xp.where(xp.isfinite(dist), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


def _soar_rho(xp, dist, length):
    disabled = ~xp.isfinite(length) | (length == 0)
    v = xp.abs(dist) / xp.where(length == 0, 1, length)
    rho = (1 + v) * xp.exp(-v)
    rho = xp.where(xp.isfinite(dist), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


def _toar_rho(xp, dist, length):
    disabled = ~xp.isfinite(length) | (length == 0)
    v = xp.abs(dist) / xp.where(length == 0, 1, length)
    rho = (1 + v + (v * v) / 3) * xp.exp(-v)
    rho = xp.where(xp.isfinite(dist), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


def _powerlaw_rho(xp, dist, length):
    disabled = ~xp.isfinite(length) | (length == 0)
    v = dist / xp.where(length == 0, 1, length)
    rho = 1 / (1 + 0.5 * v * v)
    rho = xp.where(xp.isfinite(dist), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


def _linear_rho(xp, diff, min_corr):
    disabled = ~xp.isfinite(min_corr) | (min_corr < 0)
    absdiff = xp.minimum(xp.abs(diff), 1.0)
    rho = 1 - (1 - min_corr) * absdiff
    rho = xp.where(xp.isfinite(diff), rho, 0.0)
    return xp.where(disabled, 1.0, rho)


_KERNELS = {
    "barnes": _barnes_rho,
    "cressman": _cressman_rho,
    "soar": _soar_rho,
    "toar": _toar_rho,
    "powerlaw": _powerlaw_rho,
    "linear": _linear_rho,
}


class _NpWrap:
    """numpy facade with the operations the kernels need."""
    isfinite = staticmethod(np.isfinite)
    where = staticmethod(np.where)
    exp = staticmethod(np.exp)
    abs = staticmethod(np.abs)
    minimum = staticmethod(np.minimum)
    sqrt = staticmethod(np.sqrt)


def _t_isfinite(x):
    # a scalar length scale gives a numpy bool, so `~` stays a logical not
    if isinstance(x, torch.Tensor):
        return torch.isfinite(x)
    return np.isfinite(x)


def _t_where(cond, a, b):
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    return torch.where(cond, a, b)


def _t_abs(x):
    return torch.abs(x) if isinstance(x, torch.Tensor) else abs(x)


def _t_minimum(a, b):
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


class _TorchWrap:
    """torch facade; scalar structure parameters stay Python numbers."""
    isfinite = staticmethod(_t_isfinite)
    where = staticmethod(_t_where)
    exp = staticmethod(torch.exp)
    abs = staticmethod(_t_abs)
    minimum = staticmethod(_t_minimum)
    sqrt = staticmethod(torch.sqrt)


def _hdist(xp, p1, p2):
    dx = p1["x"] - p2["x"]
    dy = p1["y"] - p2["y"]
    dz = p1["z"] - p2["z"]
    return xp.sqrt(dx * dx + dy * dy + dz * dz)


def _fields_from_point(p: Point):
    return {"x": np.float64(p.x), "y": np.float64(p.y), "z": np.float64(p.z),
            "elev": np.float32(p.elev), "laf": np.float32(p.laf),
            "lat": np.float64(p.lat), "lon": np.float64(p.lon)}


def _fields_from_points(pts):
    if isinstance(pts, Point):
        return _fields_from_point(pts)
    return {
        "x": np.array([p.x for p in pts]),
        "y": np.array([p.y for p in pts]),
        "z": np.array([p.z for p in pts]),
        "elev": np.array([p.elev for p in pts], np.float32),
        "laf": np.array([p.laf for p in pts], np.float32),
        "lat": np.array([p.lat for p in pts]),
        "lon": np.array([p.lon for p in pts]),
    }


class StructureFunction:
    """Base class; subclasses set kernel type and length-scale logic."""

    default_min_rho = 0.0013

    def __init__(self, localization_distance=0.0):
        if not np.isfinite(localization_distance) or localization_distance < 0:
            raise ValueError(
                "Structure function initizlied with invalid localization "
                "distance")
        self._localization_distance = float(localization_distance)

    # ---- host parity API ------------------------------------------------
    def corr(self, p1, p2):
        f1 = self.resolve_p1_np(_fields_from_point(p1))
        f2 = _fields_from_points(p2)
        out = self._corr(_NpWrap, np, f1, f2)
        if isinstance(p2, Point):
            return float(np.asarray(out).ravel()[0])
        return np.asarray(out, np.float32)

    def corr_background(self, p1, p2):
        f1 = self.resolve_p1_np(_fields_from_point(p1))
        f2 = _fields_from_points(p2)
        out = self._corr_background(_NpWrap, np, f1, f2)
        if isinstance(p2, Point):
            return float(np.asarray(out).ravel()[0])
        return np.asarray(out, np.float32)

    def localization_distance(self, p: Point) -> float:
        return float(self.localization_np(np.asarray([p.lat]),
                                          np.asarray([p.lon]))[0])

    # ---- vectorized host helpers ---------------------------------------
    def localization_np(self, lats, lons) -> np.ndarray:
        """Localization radius for each query point."""
        lats = np.atleast_1d(np.asarray(lats, np.float64)).ravel()
        return np.full(lats.shape, self._localization_distance)

    def resolve_p1_np(self, fields: dict) -> dict:
        """Attach any per-point length scales to a p1 field dict (host)."""
        return fields

    # ---- device API -----------------------------------------------------
    def corr_torch(self, p1: dict, p2: dict):
        return self._corr(_TorchWrap, torch, p1, p2)

    def corr_background_torch(self, p1: dict, p2: dict):
        return self._corr_background(_TorchWrap, torch, p1, p2)

    # ---- internals ------------------------------------------------------
    def _corr(self, xp, mod, p1, p2):
        raise NotImplementedError

    def _corr_background(self, xp, mod, p1, p2):
        return self._corr(xp, mod, p1, p2)

    def clone(self):
        return self


class _KernelStructure(StructureFunction):
    """Shared logic for Barnes/SOAR/TOAR/Powerlaw/Linear: scalar or
    spatially varying h/v/w with analytic localization from min_rho."""

    kernel_name = "barnes"

    def __init__(self, *args, **kwargs):
        # Two ctor forms (structure.cpp:143-184):
        #   (h, v=0, w=0, hmax=MV) scalars
        #   (grid, h2, v2, w2, min_rho=default) spatially varying
        from .core.grid import Grid
        if args and isinstance(args[0], Grid):
            grid = args[0]
            h, v, w = (np.asarray(a, np.float32) for a in args[1:4])
            min_rho = float(args[4]) if len(args) > 4 else \
                float(kwargs.get("min_rho", self.default_min_rho))
            StructureFunction.__init__(self, 0.0)
            self.m_min_rho = min_rho
            if h.size == 1 and v.size == 1 and w.size == 1:
                self.is_spatial = False
                self.h = float(h.ravel()[0])
                self.v = float(v.ravel()[0])
                self.w = float(w.ravel()[0])
                self.grid = None
            else:
                self.is_spatial = True
                gy, gx = grid.size()
                for arr in (h, v, w):
                    if arr.shape != (gy, gx):
                        raise ValueError(
                            "Grid size not the same as scale size")
                self.grid = grid
                self.h2, self.v2, self.w2 = h, v, w
        else:
            h = float(args[0]) if args else float(kwargs.get("h"))
            v = float(args[1]) if len(args) > 1 else float(kwargs.get("v", 0))
            w = float(args[2]) if len(args) > 2 else float(kwargs.get("w", 0))
            hmax = float(args[3]) if len(args) > 3 else \
                float(kwargs.get("hmax", MV))
            if np.isfinite(hmax) and hmax < 0:
                raise ValueError("hmax must be >= 0")
            for name, val in (("h", h), ("v", v), ("w", w)):
                if not np.isfinite(val) or val < 0:
                    raise ValueError(f"{name} must be >= 0")
            StructureFunction.__init__(self, 0.0)
            self.is_spatial = False
            self.grid = None
            self.h, self.v, self.w = h, v, w
            if np.isfinite(hmax):
                self.m_min_rho = self._min_rho_from_hmax(hmax, h)
                # The analytic inversion of min_rho is exactly hmax; use it
                # directly so boundary points (dist == hmax) stay included
                # despite exp/log round-off (reference test_barnes_structure
                # test_hmax relies on inclusivity).
                self._hmax_loc = hmax
            else:
                self.m_min_rho = self.default_min_rho
                self._hmax_loc = None

    # subclasses override (structure.cpp:154-157, 329, 479, 630)
    def _min_rho_from_hmax(self, hmax, h):
        return math.exp(-0.5 * (hmax / h) ** 2) if h > 0 else \
            self.default_min_rho

    def _loc_from_h(self, h):
        """localization_distance(h) (structure.cpp:280-282 for Barnes)."""
        return math.sqrt(-2 * math.log(self.m_min_rho)) * h

    def _loc(self, h):
        if getattr(self, "_hmax_loc", None) is not None:
            return self._hmax_loc + 0.0 * h
        return self._loc_from_h(h)

    def localization_np(self, lats, lons):
        lats = np.atleast_1d(np.asarray(lats, np.float64)).ravel()
        lons = np.atleast_1d(np.asarray(lons, np.float64)).ravel()
        if self.is_spatial:
            h, _, _ = self.resolve_hvw_np(lats, lons)
            return np.asarray(self._loc(h), np.float64)
        return np.full(lats.shape, float(self._loc(self.h)))

    def resolve_hvw_np(self, lats, lons):
        """Per-point h/v/w from the scale grid (structure.cpp:188-213)."""
        if not self.is_spatial:
            n = np.atleast_1d(np.asarray(lats)).ravel().shape[0]
            return (np.full(n, self.h, np.float32),
                    np.full(n, self.v, np.float32),
                    np.full(n, self.w, np.float32))
        flat = self.grid.nearest_map(lats, lons)
        return (self.h2.ravel()[flat], self.v2.ravel()[flat],
                self.w2.ravel()[flat])

    def resolve_p1_np(self, fields: dict) -> dict:
        if not self.is_spatial:
            # scalar length scales live in the closure; no per-point arrays
            return fields
        h, v, w = self.resolve_hvw_np(fields["lat"], fields["lon"])
        out = dict(fields)
        out["h"], out["v"], out["w"] = h, v, w
        return out

    def _get_hvw(self, xp, p1):
        if "h" in p1:
            return p1["h"], p1["v"], p1["w"]
        if self.is_spatial:
            raise ValueError(
                "Spatial structure requires resolved h/v/w on p1 "
                "(call resolve_p1_np)")
        return self.h, self.v, self.w

    def _corr(self, xp, mod, p1, p2):
        kernel = _KERNELS[self.kernel_name]
        h, v, w = self._get_hvw(xp, p1)
        hd = _hdist(xp, p1, p2)
        rho = kernel(xp, hd, h)
        e1 = p1["elev"]
        e2 = p2["elev"]
        both_e = xp.isfinite(e1) & xp.isfinite(e2)
        rho = rho * xp.where(both_e, kernel(xp, xp.where(both_e, e1 - e2, 0.0),
                                            v), 1.0)
        l1 = p1["laf"]
        l2 = p2["laf"]
        both_l = xp.isfinite(l1) & xp.isfinite(l2)
        rho = rho * xp.where(both_l, kernel(xp, xp.where(both_l, l1 - l2, 0.0),
                                            w), 1.0)
        loc = self._loc(h)
        rho = xp.where(hd <= loc, rho, 0.0)
        return rho


class BarnesStructure(_KernelStructure):
    """Gaussian kernel (structure.cpp:143-283)."""
    kernel_name = "barnes"

    def _min_rho_from_hmax(self, hmax, h):
        return math.exp(-0.5 * (hmax / h) ** 2) if h > 0 else 0.0

    def _loc_from_h(self, h):
        if self.m_min_rho <= 0:
            return np.inf * (1 + 0 * h) if not np.isscalar(h) else np.inf
        return math.sqrt(-2 * math.log(self.m_min_rho)) * h


class SoarStructure(_KernelStructure):
    """Second-order autoregressive kernel (structure.cpp:317-463)."""
    kernel_name = "soar"

    def _min_rho_from_hmax(self, hmax, h):
        return (1 + hmax / h) * math.exp(-hmax / h) if h > 0 else 1.0

    def _loc_from_h(self, h):
        log_min_rho = math.log(self.m_min_rho)
        return (-log_min_rho + math.log(-log_min_rho)) * h


class ToarStructure(_KernelStructure):
    """Third-order autoregressive kernel (structure.cpp:467-614)."""
    kernel_name = "toar"

    def _min_rho_from_hmax(self, hmax, h):
        r = hmax / h
        return (1 + r + r * r / 3) * math.exp(-r) if h > 0 else 1.0

    def _loc_from_h(self, h):
        log_min_rho = math.log(self.m_min_rho)
        log_log = math.log(-log_min_rho)
        return (-log_min_rho + log_log + 0.5 * log_log) * h


class PowerlawStructure(_KernelStructure):
    """Power-law kernel (structure.cpp:618-761)."""
    kernel_name = "powerlaw"

    def _min_rho_from_hmax(self, hmax, h):
        return 1 / (1 + 0.5 * (hmax / h) ** 2) if h > 0 else 1.0

    def _loc_from_h(self, h):
        return math.sqrt(2 * (1 / self.m_min_rho - 1)) * h


class LinearStructure(_KernelStructure):
    """Linear correlation on generic value differences
    (structure.cpp:765-906). Localization distance is 0."""
    kernel_name = "linear"

    def _min_rho_from_hmax(self, hmax, h):
        return self.default_min_rho

    def _loc_from_h(self, h):
        return 0.0 * h

    def _corr(self, xp, mod, p1, p2):
        # No localization zeroing (localization distance is 0 and the
        # reference's check `hdist > 0` would zero everything; the reference
        # instead only checks in the scalar path where loc=0 means
        # hdist > 0 -> 0. Reproduce that: distance > 0 -> 0? No: reference
        # corr checks hdist > localization_distance(p1)=0, so any hdist>0
        # gives rho 0. Keep that behaviour.
        kernel = _KERNELS[self.kernel_name]
        h, v, w = self._get_hvw(xp, p1)
        hd = _hdist(xp, p1, p2)
        rho = kernel(xp, hd, h)
        e1, e2 = p1["elev"], p2["elev"]
        both_e = xp.isfinite(e1) & xp.isfinite(e2)
        rho = rho * xp.where(both_e, kernel(xp, xp.where(both_e, e1 - e2, 0.0),
                                            v), 1.0)
        l1, l2 = p1["laf"], p2["laf"]
        both_l = xp.isfinite(l1) & xp.isfinite(l2)
        rho = rho * xp.where(both_l, kernel(xp, xp.where(both_l, l1 - l2, 0.0),
                                            w), 1.0)
        rho = xp.where(hd <= 0, rho, 0.0)
        return rho


class CressmanStructure(StructureFunction):
    """Cressman kernel; localization distance is h (structure.cpp:287-312)."""

    def __init__(self, h, v=0, w=0):
        for name, val in (("v", v), ("w", w)):
            if not np.isfinite(val) or val < 0:
                raise ValueError(f"{name} must be >= 0")
        StructureFunction.__init__(self, float(h))
        self.h = float(h)
        self.v = float(v)
        self.w = float(w)

    def _corr(self, xp, mod, p1, p2):
        hd = _hdist(xp, p1, p2)
        rho = _cressman_rho(xp, hd, self.h)
        e1, e2 = p1["elev"], p2["elev"]
        both_e = xp.isfinite(e1) & xp.isfinite(e2)
        rho = rho * xp.where(both_e, _cressman_rho(
            xp, xp.where(both_e, e1 - e2, 0.0), self.v), 1.0)
        l1, l2 = p1["laf"], p2["laf"]
        both_l = xp.isfinite(l1) & xp.isfinite(l2)
        rho = rho * xp.where(both_l, _cressman_rho(
            xp, xp.where(both_l, l1 - l2, 0.0), self.w), 1.0)
        return rho


class MultipleStructure(StructureFunction):
    """Compose three structures for the h/v/w dimensions
    (structure.cpp:90-138)."""

    def __init__(self, structure_h, structure_v, structure_w):
        StructureFunction.__init__(self, 0.0)
        self.structure_h = structure_h.clone()
        self.structure_v = structure_v.clone()
        self.structure_w = structure_w.clone()

    def localization_np(self, lats, lons):
        return self.structure_h.localization_np(lats, lons)

    def resolve_p1_np(self, fields):
        return self.structure_h.resolve_p1_np(fields)

    def _corr(self, xp, mod, p1, p2):
        # h-part: real positions, p1's elev/laf on both sides
        p2_h = dict(p2)
        p2_h["elev"] = p1["elev"]
        p2_h["laf"] = p1["laf"]
        # v-part: p1's position, real elevs
        p2_v = dict(p1)
        p2_v["elev"] = p2["elev"]
        # w-part: p1's position, real lafs
        p2_w = dict(p1)
        p2_w["laf"] = p2["laf"]
        ch = self.structure_h._corr(xp, mod, p1, p2_h)
        cv = self.structure_v._corr(xp, mod, p1, p2_v)
        cw = self.structure_w._corr(xp, mod, p1, p2_w)
        return ch * cv * cw

    def clone(self):
        return MultipleStructure(self.structure_h, self.structure_v,
                                 self.structure_w)


class CrossValidation(StructureFunction):
    """Wrap another structure, zeroing corr_background within `dist`
    (structure.cpp:910-943) to exclude an observation's own neighbourhood."""

    def __init__(self, structure, dist=MV):
        if not np.isfinite(dist) or dist < 0:
            raise ValueError("Invalid 'dist' in CrossValidation structure")
        StructureFunction.__init__(self, 0.0)
        self.structure = structure.clone()
        self.dist = float(dist)

    def localization_np(self, lats, lons):
        return self.structure.localization_np(lats, lons)

    def resolve_p1_np(self, fields):
        return self.structure.resolve_p1_np(fields)

    def _corr(self, xp, mod, p1, p2):
        return self.structure._corr(xp, mod, p1, p2)

    def _corr_background(self, xp, mod, p1, p2):
        rho = self.structure._corr_background(xp, mod, p1, p2)
        hd = _hdist(xp, p1, p2)
        return xp.where(hd <= self.dist, 0.0, rho)

    def clone(self):
        return CrossValidation(self.structure, self.dist)
