"""Native host engine: builds and wraps the repository's csrc/ sources.

The same C++ as gridpp_tpu's native engine (csrc/gridpp_native.cpp and
csrc/gridpp_kernels.cpp), compiled with g++ on first use into this
package's own build directory (see _build.py). The library holds the
cell-hash spatial index, `pair_rho_host`, whose rho bits make the
canonical shortlist (ops/canonical.py) identical to gridpp_tpu's, the
host neighbourhood kernels behind the numpy API (api/neighbourhood.py),
the fused linear-regression gradient (`calc_gradient_lr`, api/gradients.py),
the calibration-curve application (`apply_curve`, api/curves.py), the
running window (`window_run`, api/window_api.py), the conditional
neighbourhood mean (`nb_search`, api/search.py), the local distribution
correction (`ldc_host`, api/ldc.py), square doping (`doping_square`,
api/fill.py), the index's fused radius statistic and circle paint
(`NativeIndex.radius_stat`, `.paint`; api/gridding.py, api/fill.py), and
the threaded per-gridpoint OI solvers of the OI API's host route
(`oi_host_solve`, `oi_ensi_host_solve`, `oi_member_host_solve`,
`oi_utem_host_solve`; api/oi.py, api/oi_ensi.py, api/oi_ensi_multi.py).
When no compiler is available the callers fall back to scipy, numpy and
the port's ops, as gridpp_tpu's do.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .._build import build_shared

_lock = threading.Lock()
_lib = None
_tried = False

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SRCS = [os.path.join(_CSRC, "gridpp_native.cpp"),
         os.path.join(_CSRC, "gridpp_kernels.cpp")]


def _build() -> str | None:
    if not all(os.path.exists(s) for s in _SRCS):
        return None
    try:
        return build_shared(
            "gridpp_native", _SRCS,
            lambda out: ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                         "-pthread", "-o", out] + _SRCS, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        c_p = ctypes.c_void_p
        c_i64 = ctypes.c_int64
        c_i32 = ctypes.c_int32
        lib.nb_brute.argtypes = [c_p, c_i64, c_i64, c_i64, c_i32,
                                 ctypes.c_double, c_i64, c_p]
        lib.nb_meansum.argtypes = [c_p, c_i64, c_i64, c_i64, c_i32, c_p]
        lib.calc_gradient_lr.argtypes = [c_p, c_p, c_i64, c_i64, c_i64,
                                         c_i64, ctypes.c_float, c_i32,
                                         ctypes.c_float, c_p]
        lib.apply_curve_1d.argtypes = [c_p, c_i64, c_p, c_p, c_i64, c_i32,
                                       c_i32, c_p]
        lib.apply_curve_percell.argtypes = [c_p, c_i64, c_p, c_p, c_i64,
                                            c_i32, c_i32, c_p]
        lib.nb_quantile_fast.argtypes = [c_p, c_i64, c_i64, c_i64, c_p,
                                         c_i64, c_p, ctypes.c_float, c_p]
        lib.nb_search.argtypes = [c_p, c_p, c_i64, c_i64, c_i64,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, c_p, c_i32, c_p]
        lib.doping_square.argtypes = [c_p, c_p, c_p, c_p, c_p, c_p, c_i64,
                                      c_i64, c_i64, c_i32, ctypes.c_float,
                                      c_p]
        lib.window_run.argtypes = [c_p, c_i64, c_i64, c_i64, c_i32, c_i32,
                                   c_i32, c_i32, c_p]
        lib.index_paint.argtypes = [c_p, c_p, c_i64, c_p, c_p, c_p, c_p,
                                    c_p, c_i32, ctypes.c_float, c_p]
        lib.index_build.restype = c_p
        lib.index_build.argtypes = [c_p, c_i64, ctypes.c_double]
        lib.index_free.argtypes = [c_p]
        lib.index_nearest.argtypes = [c_p, c_p, c_i64, c_p]
        lib.index_knearest.argtypes = [c_p, c_p, c_i64, c_i32, c_p, c_p]
        lib.index_radius_count.argtypes = [c_p, c_p, c_i64,
                                           ctypes.c_double, c_p]
        lib.index_radius_stat.argtypes = [c_p, c_p, c_i64, ctypes.c_double,
                                          c_p, c_i32, ctypes.c_double,
                                          c_i64, c_p]
        lib.pair_rho_host.argtypes = (
            [c_p] * 9 + [c_i64] + [c_p] * 5 + [c_p, c_p, c_i64]
            + [c_i32] + [c_p])
        lib.oi_host_solve.argtypes = (
            [c_p] * 9 + [c_i64] + [c_p] * 12 + [c_p, c_p, c_i64]
            + [c_i32, c_i32, c_i32] + [c_p] * 4)
        lib.oi_ensi_host_solve.argtypes = (
            [c_p] * 9 + [c_i64] + [c_p] * 13 + [c_p, c_p, c_i64]
            + [c_i32, c_i32, c_i32, c_i32] + [c_p] * 3)
        lib.oi_member_host_solve.argtypes = (
            [c_p] * 9 + [c_i64] + [c_p] * 14 + [c_p, c_p, c_i64]
            + [c_i32, c_i32, c_i32, c_i32, c_i32] + [c_p] * 2)
        lib.oi_utem_host_solve.argtypes = (
            [c_p] * 9 + [c_i64] + [c_p] * 15 + [c_p, c_p, c_i64]
            + [c_i32, c_i32, c_i32, c_i32] + [ctypes.c_double] + [c_p] * 4)
        lib.ldc_host.argtypes = [c_p, c_i64, c_p, c_p, c_p, c_i64, c_p, c_p,
                                 c_i64, c_i64, ctypes.c_float,
                                 ctypes.c_float, c_i32, c_p]
        _lib = lib
        return _lib


class NativeIndex:
    """ctypes wrapper over the cell-hash index."""

    def __init__(self, xyz: np.ndarray):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native engine unavailable")
        self._lib = lib
        self._xyz = np.ascontiguousarray(xyz, dtype=np.float64)
        self._handle = lib.index_build(_ptr(self._xyz), self._xyz.shape[0],
                                       0.0)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.index_free(self._handle)
            self._handle = None

    def nearest(self, q: np.ndarray) -> np.ndarray:
        q = np.ascontiguousarray(q, dtype=np.float64)
        out = np.empty(q.shape[0], dtype=np.int32)
        self._lib.index_nearest(self._handle, _ptr(q), q.shape[0], _ptr(out))
        return out

    def knearest(self, q: np.ndarray, k: int):
        q = np.ascontiguousarray(q, dtype=np.float64)
        nq = q.shape[0]
        idx = np.empty((nq, k), dtype=np.int32)
        dist = np.empty((nq, k), dtype=np.float64)
        self._lib.index_knearest(self._handle, _ptr(q), nq, np.int32(k),
                                 _ptr(idx), _ptr(dist))
        return idx, dist

    def radius_count(self, q: np.ndarray, radius: float) -> np.ndarray:
        q = np.ascontiguousarray(q, dtype=np.float64)
        out = np.empty(q.shape[0], dtype=np.int32)
        self._lib.index_radius_count(self._handle, _ptr(q), q.shape[0],
                                     float(radius), _ptr(out))
        return out

    def radius_stat(self, q: np.ndarray, radius: float, values: np.ndarray,
                    stat: int, quantile: float = 0.5,
                    min_num: int = 0) -> np.ndarray:
        """Fused radius query + statistic over the indexed points' values."""
        q = np.ascontiguousarray(q, dtype=np.float64)
        v = _f32c(values)
        out = np.empty(q.shape[0], dtype=np.float32)
        self._lib.index_radius_stat(self._handle, _ptr(q), q.shape[0],
                                    float(radius), _ptr(v), int(stat),
                                    float(quantile), int(min_num), _ptr(out))
        return out

    def paint(self, q: np.ndarray, radii: np.ndarray, out: np.ndarray,
              values: np.ndarray | None = None,
              src: np.ndarray | None = None,
              pelev: np.ndarray | None = None,
              gelev: np.ndarray | None = None,
              max_diff: float = 0.0) -> None:
        """Sequential circle scatter onto the indexed points, in place.

        For query i, the indexed points within radii[i] get values[i] (or
        src[point] when src is given); with pelev and gelev, only those
        within max_diff of the query's elevation. out: a C-contiguous f32
        array."""
        q = np.ascontiguousarray(q, dtype=np.float64)
        radii = np.ascontiguousarray(radii, dtype=np.float64)
        values_c = None if values is None else _f32c(values)
        src_c = None if src is None else _f32c(src)
        check = pelev is not None and gelev is not None
        pe = _f32c(pelev) if check else None
        ge = _f32c(gelev) if check else None
        self._lib.index_paint(
            self._handle, _ptr(q), q.shape[0], _ptr(radii),
            *(None if a is None else _ptr(a)
              for a in (values_c, src_c, pe, ge)),
            int(check), float(max_diff), _ptr(out))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _geom_ptrs(fx):
    return [_f32c(fx[k]) for k in ("x", "y", "z", "elev", "laf", "h",
                                   "v", "w", "loc")]


def pair_rho_host(gfx, ofx, cand, mask, kernel_type):
    """Canonical pair-rho over explicit candidate lists (csrc
    pair_rho_host): the exact bits the native OI solvers' select_topk
    computes. gfx: per-gridpoint f32 fields x,y,z,elev,laf,h,v,w,loc;
    ofx: per-obs x,y,z,elev,laf. cand/mask: (n, K). Returns (n, K) f32
    rho (0 where masked out) or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = gfx["x"].shape[0]
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    kpad = cand.shape[1] if cand.ndim == 2 else 0
    rho = np.empty((n, kpad), np.float32)
    garrs = _geom_ptrs(gfx)
    oarrs = [_f32c(ofx[k]) for k in ("x", "y", "z", "elev", "laf")]
    lib.pair_rho_host(
        *[_ptr(a) for a in garrs], n,
        *[_ptr(a) for a in oarrs],
        _ptr(cand), _ptr(mask), kpad, int(kernel_type), _ptr(rho))
    return rho


def nb_brute(values: np.ndarray, halfwidth: int, stat: int,
             quantile: float = 0.5) -> np.ndarray | None:
    """Brute-force windowed statistic; values (Y, X) or (Y, X, E). None
    when the native engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v = _f32c(values)
    ny, nx = v.shape[0], v.shape[1]
    ne = v.shape[2] if v.ndim == 3 else 1
    out = np.empty((ny, nx), np.float32)
    lib.nb_brute(_ptr(v), ny, nx, ne, int(stat), float(quantile),
                 int(halfwidth), _ptr(out))
    return out


def nb_meansum(values: np.ndarray, halfwidth: int,
               stat: int) -> np.ndarray | None:
    """Running-sum neighbourhood Mean/Sum/Count/Std/Variance, (Y, X)."""
    lib = get_lib()
    if lib is None:
        return None
    v = _f32c(values)
    ny, nx = v.shape
    out = np.empty((ny, nx), np.float32)
    lib.nb_meansum(_ptr(v), ny, nx, int(halfwidth), int(stat), _ptr(out))
    return out


def nb_quantile_fast(values: np.ndarray, halfwidth: int,
                     thresholds: np.ndarray, qfield: np.ndarray | None,
                     q_scalar: float) -> np.ndarray | None:
    """Fused threshold-CDF windowed quantile (neighbourhood.cpp:296-527);
    qfield (Y, X), when given, overrides q_scalar per cell."""
    lib = get_lib()
    if lib is None:
        return None
    v = _f32c(values)
    thr = _f32c(thresholds)
    ny, nx = v.shape
    qf = None if qfield is None else _f32c(qfield)
    out = np.empty((ny, nx), np.float32)
    lib.nb_quantile_fast(_ptr(v), ny, nx, int(halfwidth), _ptr(thr),
                         thr.size, None if qf is None else _ptr(qf),
                         float(q_scalar), _ptr(out))
    return out


def calc_gradient_lr(base: np.ndarray, values: np.ndarray, halfwidth: int,
                     min_num: int, min_range: float, use_min_range: bool,
                     default_gradient: float) -> np.ndarray | None:
    """Fused windowed linear-regression gradient (calc_gradient.cpp:
    76-124): the five windowed moments summed in double, the gradient in
    f32. None when the native engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    b = _f32c(base)
    v = _f32c(values)
    ny, nx = b.shape
    out = np.empty((ny, nx), np.float32)
    lib.calc_gradient_lr(_ptr(b), _ptr(v), ny, nx, int(halfwidth),
                         int(min_num), float(min_range),
                         int(bool(use_min_range)), float(default_gradient),
                         _ptr(out))
    return out


def apply_curve(fcst: np.ndarray, curve_ref: np.ndarray,
                curve_fcst: np.ndarray, policy_below: int,
                policy_above: int) -> np.ndarray | None:
    """apply_curve on the host (curve.cpp:6-133); the curves 1-D (shared)
    or (..., C) per cell. None when the native engine is unavailable or
    the per-cell curves do not match fcst's shape."""
    lib = get_lib()
    if lib is None:
        return None
    f = _f32c(fcst)
    cr = _f32c(curve_ref)
    cf = _f32c(curve_fcst)
    out = np.empty(f.shape, np.float32)
    if cr.ndim == 1:
        lib.apply_curve_1d(_ptr(f), f.size, _ptr(cr), _ptr(cf), cr.shape[-1],
                           int(policy_below), int(policy_above), _ptr(out))
    else:
        if cr.shape[:-1] != f.shape:
            return None
        lib.apply_curve_percell(_ptr(f), f.size, _ptr(cr), _ptr(cf),
                                cr.shape[-1], int(policy_below),
                                int(policy_above), _ptr(out))
    return out


def window_run(array: np.ndarray, length: int, stat: int, before: bool,
               keep_missing: bool, missing_edges: bool) -> np.ndarray | None:
    """Running-window Mean/Sum/Count along the last axis of (Case, T)
    (window.cpp:6-156). None when the native engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = _f32c(array)
    out = np.empty(a.shape, np.float32)
    lib.window_run(_ptr(a), a.shape[0], a.shape[1], int(length), int(stat),
                   int(before), int(keep_missing), int(missing_edges),
                   _ptr(out))
    return out


def nb_search(array: np.ndarray, search_array: np.ndarray, halfwidth: int,
              target_min: float, target_max: float, delta: float,
              apply_array: np.ndarray | None) -> np.ndarray | None:
    """Conditional neighbourhood mean (neighbourhood_search.cpp:7-113) of
    (Y, X) arrays. None when the native engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = _f32c(array)
    s = _f32c(search_array)
    ny, nx = a.shape
    use_apply = apply_array is not None
    ap = _f32c(apply_array) if use_apply else a
    out = np.empty((ny, nx), np.float32)
    lib.nb_search(_ptr(a), _ptr(s), ny, nx, int(halfwidth),
                  float(target_min), float(target_max), float(delta),
                  _ptr(ap), int(use_apply), _ptr(out))
    return out


def doping_square(cy: np.ndarray, cx: np.ndarray, obs: np.ndarray,
                  hw: np.ndarray, pelev: np.ndarray, gelev: np.ndarray,
                  ny: int, nx: int, check_elev: bool, max_diff: float,
                  out: np.ndarray) -> bool:
    """Square doping (doping.cpp:5-48) in place over the C-contiguous f32
    `out` (ny, nx). False when the native engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    cy = np.ascontiguousarray(cy, np.int64)
    cx = np.ascontiguousarray(cx, np.int64)
    obs = _f32c(obs)
    hw = np.ascontiguousarray(hw, np.int64)
    pelev = _f32c(pelev)
    gelev = _f32c(gelev)
    lib.doping_square(_ptr(cy), _ptr(cx), _ptr(obs), _ptr(hw), _ptr(pelev),
                      _ptr(gelev), cy.size, int(ny), int(nx),
                      int(check_elev), float(max_diff), _ptr(out))
    return True


def ldc_host(background, cand, mask, rho, pobs, pbackground, min_quantile,
             max_quantile, min_points):
    """Threaded local_distribution_correction (csrc ldc_host).

    background: (N,) flattened; cand/mask/rho: (N, K); pobs/pbackground:
    (T, S) per-obs time series. Returns (N,) f32 or None when the native
    engine is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    bg = _f32c(background)
    n = bg.shape[0]
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    rho = _f32c(rho)
    obs = _f32c(pobs)
    fcst = _f32c(pbackground)
    t, s_obs = obs.shape
    out = np.empty(n, np.float32)
    lib.ldc_host(_ptr(bg), n, _ptr(cand), _ptr(mask), _ptr(rho),
                 cand.shape[1], _ptr(obs), _ptr(fcst), t, s_obs,
                 float(min_quantile), float(max_quantile),
                 int(min_points), _ptr(out))
    return out


def oi_host_solve(gfx, ofx, obs, oyb, oratio, cand, mask, kernel_type,
                  max_points, allow_extrapolation, background, bvariance):
    """Threaded per-gridpoint OI solve (csrc oi_host_solve).

    gfx/ofx: dicts with f32 arrays x,y,z,elev,laf,h,v,w,loc for the
    gridpoints / observations. Returns (analysis, avariance) or None
    when the native engine is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = gfx["x"].shape[0]
    out = np.empty(n, np.float32)
    avar = np.empty(n, np.float32)
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    kpad = cand.shape[1]
    # materialize every converted array BEFORE taking pointers, so the
    # temporaries stay alive through the call
    garrs = _geom_ptrs(gfx)
    oarrs = _geom_ptrs(ofx)
    varrs = [_f32c(obs), _f32c(oyb), _f32c(oratio)]
    bgarrs = [_f32c(background), _f32c(bvariance)]
    lib.oi_host_solve(
        *[_ptr(a) for a in garrs], n,
        *[_ptr(a) for a in oarrs],
        *[_ptr(a) for a in varrs],
        _ptr(cand), _ptr(mask), kpad,
        int(kernel_type), int(max_points), int(bool(allow_extrapolation)),
        *[_ptr(a) for a in bgarrs],
        _ptr(out), _ptr(avar))
    return out, avar


def oi_ensi_host_solve(gfx, ofx, obs, sigmas, yhat, yanom, cand, mask,
                       kernel_type, max_points, allow_extrapolation,
                       background):
    """Threaded per-gridpoint EnSI solve (csrc oi_ensi_host_solve).

    background/yanom: (n, E)/(P, E) f32 row-major. Returns
    (analysis (n, E), cond_bad (n,) uint8) or None when unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    background = np.ascontiguousarray(background, np.float32)
    n, n_ens = background.shape
    yanom = np.ascontiguousarray(yanom, np.float32)
    out = np.empty((n, n_ens), np.float32)
    cond_bad = np.empty(n, np.uint8)
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    kpad = cand.shape[1]
    garrs = _geom_ptrs(gfx)
    oarrs = _geom_ptrs(ofx)
    varrs = [_f32c(obs), _f32c(sigmas), _f32c(yhat), yanom]
    lib.oi_ensi_host_solve(
        *[_ptr(a) for a in garrs], n,
        *[_ptr(a) for a in oarrs],
        *[_ptr(a) for a in varrs],
        _ptr(cand), _ptr(mask), kpad,
        int(kernel_type), int(max_points), int(bool(allow_extrapolation)),
        int(n_ens),
        _ptr(background), _ptr(out), _ptr(cond_bad))
    return out, cond_bad


def oi_member_host_solve(gfx, ofx, oratio, innov, zr, xl, bratios, cand,
                         mask, kernel_type, max_points,
                         allow_extrapolation, use_z, background):
    """Threaded ebe/ebesc member-by-member solve (csrc
    oi_member_host_solve). Returns analysis (n, E) or None."""
    lib = get_lib()
    if lib is None:
        return None
    background = np.ascontiguousarray(background, np.float32)
    n, n_ens = background.shape
    innov = np.ascontiguousarray(innov, np.float32)
    p = innov.shape[0]
    if zr is None:
        zr = np.zeros((p, n_ens), np.float32)
    if xl is None:
        xl = np.zeros((n, n_ens), np.float32)
    out = np.empty((n, n_ens), np.float32)
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    garrs = _geom_ptrs(gfx)
    oarrs = _geom_ptrs(ofx)
    varrs = [_f32c(oratio), innov,
             np.ascontiguousarray(zr, np.float32),
             np.ascontiguousarray(xl, np.float32),
             _f32c(bratios)]
    lib.oi_member_host_solve(
        *[_ptr(a) for a in garrs], n,
        *[_ptr(a) for a in oarrs],
        *[_ptr(a) for a in varrs],
        _ptr(cand), _ptr(mask), cand.shape[1],
        int(kernel_type), int(max_points), int(bool(allow_extrapolation)),
        int(n_ens), int(bool(use_z)),
        _ptr(background), _ptr(out))
    return out


def oi_utem_host_solve(gfx, ofx, obs, oratio, yhat, yanom, ycorr, bratios,
                       cand, mask, kernel_type, max_points,
                       allow_extrapolation, min_std, background,
                       background_corr):
    """Threaded utem ETKF solve (csrc oi_utem_host_solve). Returns
    (analysis (n, E), cond_bad (n,) uint8) or None."""
    lib = get_lib()
    if lib is None:
        return None
    background = np.ascontiguousarray(background, np.float32)
    background_corr = np.ascontiguousarray(background_corr, np.float32)
    n, n_ens = background.shape
    out = np.empty((n, n_ens), np.float32)
    cond_bad = np.empty(n, np.uint8)
    cand = np.ascontiguousarray(cand, np.int32)
    mask = np.ascontiguousarray(mask, np.uint8)
    garrs = _geom_ptrs(gfx)
    oarrs = _geom_ptrs(ofx)
    varrs = [_f32c(obs), _f32c(oratio), _f32c(yhat),
             np.ascontiguousarray(yanom, np.float32),
             np.ascontiguousarray(ycorr, np.float32),
             _f32c(bratios)]
    lib.oi_utem_host_solve(
        *[_ptr(a) for a in garrs], n,
        *[_ptr(a) for a in oarrs],
        *[_ptr(a) for a in varrs],
        _ptr(cand), _ptr(mask), cand.shape[1],
        int(kernel_type), int(max_points), int(bool(allow_extrapolation)),
        int(n_ens), float(min_std),
        _ptr(background), _ptr(background_corr),
        _ptr(out), _ptr(cond_bad))
    return out, cond_bad
