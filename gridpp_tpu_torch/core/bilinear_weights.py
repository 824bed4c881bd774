"""Host precompute of bilinear interpolation weights (a numpy float64 copy
of gridpp_tpu/core/bilinear_weights.py, held to it bit for bit).

The reference solves per-output-cell for (s,t) inside its OMP hot loop
(reference bilinear.cpp:138-260). Geometry depends only on the grid pair,
so here the whole solve is vectorized NumPy float64 run ONCE per grid pair;
device apply is then 4 gathers + a weighted blend (see ops/downscaling.py).

Weight math matches the reference:
- parallelogram fast path (bilinear.cpp:138-154)
- general quadrilateral quadratic with fallback root choice and the same
  degenerate branches (bilinear.cpp:160-260)
- +-0.15 snapping of s,t to [0,1] (bilinear.cpp:303-310)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BilinearMap:
    """Precomputed gather indices and weights for one grid pair.

    Flattened input-grid indices of the 4 box corners (P1=[I2,J1],
    P2=[I2,J2], P3=[I1,J1], P4=[I1,J2] in the reference's labelling),
    the nearest-neighbour fallback index, the (s,t) weights, and the
    inside-domain mask.
    """

    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    p4: np.ndarray
    nn: np.ndarray
    s: np.ndarray
    t: np.ndarray
    inside: np.ndarray


def _is_within_range(v):
    tol = 0.01
    return (v >= -tol) & (v < 1 + tol)


def _calc_general(x, y, x0, x1, x2, x3, y0, y1, y2, y3):
    """Vectorized calcGeneral (bilinear.cpp:160-260). Returns (s, t)."""
    a = -x0 + x2
    b = -x0 + x1
    c = x0 - x1 - x2 + x3
    d = x - x0
    e = -y0 + y2
    f = -y0 + y1
    g = y0 - y1 - y2 + y3
    h = y - y0
    X1, X2, X3, X4 = x1, x3, x0, x2
    Y1, Y2, Y3, Y4 = y1, y3, y0, y2
    X21 = X2 - X1
    X31 = X3 - X1
    X42 = X4 - X2
    X43 = X4 - X3
    Y21 = Y2 - Y1
    Y31 = Y3 - Y1
    Y42 = Y4 - Y2
    Y43 = Y4 - Y3

    den_a = 2 * c * e - 2 * a * g
    den_b = 2 * c * f - 2 * b * g
    disc = np.maximum(-4 * (c * e - a * g) * (d * f - b * h)
                      + (b * e - a * f + d * g - c * h) ** 2, 0)
    root = np.sqrt(disc)
    pa = b * e - a * f + d * g - c * h
    pb = b * e - a * f - d * g + c * h

    safe_a = np.where(den_a != 0, den_a, 1)
    safe_b = np.where(den_b != 0, den_b, 1)
    alpha_p = -(pa + root) / safe_a
    alpha_m = -(pa - root) / safe_a
    beta_p = (pb + root) / safe_b
    beta_m = (pb - root) / safe_b
    alpha = np.where(_is_within_range(alpha_p), alpha_p, alpha_m)
    beta = np.where(_is_within_range(beta_p), beta_p, beta_m)

    # Branch: den_b == 0 -> diagnose t from alpha (bilinear.cpp:198-215)
    s_a = alpha
    tden_y = Y3 + Y43 * s_a - Y1 - Y21 * s_a
    tden_x = X3 + X43 * s_a - X1 - X21 * s_a
    t_diag = np.where(tden_y == 0,
                      (x - X1 - X21 * s_a) / np.where(tden_x == 0, 1, tden_x),
                      (y - Y1 - Y21 * s_a) / np.where(tden_y == 0, 1, tden_y))
    beta_from_t = 1 - t_diag

    # Branch: den_a == 0 -> diagnose s from beta (bilinear.cpp:216-235).
    # (The reference retries the same +root formula for beta here.)
    beta_b = beta_p
    t_b = 1 - beta_b
    sden_y = Y2 + Y42 * t_b - Y1 - Y31 * t_b
    sden_x = X2 + X42 * t_b - X1 - X31 * t_b
    s_diag = np.where(sden_y == 0,
                      (x - X1 - X31 * t_b) / np.where(sden_x == 0, 1, sden_x),
                      (y - Y1 - Y31 * t_b) / np.where(sden_y == 0, 1, sden_y))

    both = (den_a != 0) & (den_b != 0)
    only_b0 = den_b == 0
    only_a0 = (den_a == 0) & ~only_b0
    s = np.where(both, alpha, np.where(only_b0, alpha, s_diag))
    beta_sel = np.where(both, beta, np.where(only_b0, beta_from_t, beta_b))
    t = 1 - beta_sel
    return s, t


def _calc_parallelogram(x, y, X1, X2, X3, X4, Y1, Y2, Y3, Y4):
    """Vectorized calcParallelogram (bilinear.cpp:138-154). Returns (s, t)."""
    A = X2 - X1
    B = X3 - X1
    C = Y2 - Y1
    D = Y3 - Y1
    det_raw = A * D - B * C
    det = 1 / np.where(det_raw == 0, 1, det_raw)
    s = det * ((x - X1) * D + (y - Y1) * (-B))
    t = det * ((x - X1) * (-C) + (y - Y1) * A)
    return s, t


def compute_bilinear_map(igrid, qlats, qlons) -> BilinearMap:
    """Build the BilinearMap from an input Grid to arbitrary output points."""
    qlats = np.asarray(qlats, dtype=np.float64).ravel()
    qlons = np.asarray(qlons, dtype=np.float64).ravel()
    n = qlats.size
    ny, nx = igrid.lats.shape if igrid.lats.size else (0, 0)
    i1, j1, i2, j2, inside = igrid.get_box_vectorized(qlats, qlons)
    nn = (igrid.nearest_map(qlats, qlons).astype(np.int64)
          if igrid.lats.size else np.zeros(n, np.int64))

    # Corner coordinates, labelled like bilinear.cpp:270-290
    lats = igrid.lats.astype(np.float64)
    lons = igrid.lons.astype(np.float64)
    ii1 = np.where(inside, i1, 0).astype(np.int64)
    jj1 = np.where(inside, j1, 0).astype(np.int64)
    ii2 = np.where(inside, i2, 0).astype(np.int64)
    jj2 = np.where(inside, j2, 0).astype(np.int64)
    x0 = lons[ii1, jj1]
    x1 = lons[ii2, jj1]
    x2 = lons[ii1, jj2]
    x3 = lons[ii2, jj2]
    y0 = lats[ii1, jj1]
    y1 = lats[ii2, jj1]
    y2 = lats[ii1, jj2]
    y3 = lats[ii2, jj2]
    # P-labelling (bilinear.cpp:262-276): 1=(I2,J1) 2=(I2,J2) 3=(I1,J1) 4=(I1,J2)
    X1, X2, X3, X4 = x1, x3, x0, x2
    Y1, Y2, Y3, Y4 = y1, y3, y0, y2

    vertical_parallel = np.abs((X3 - X1) * (Y4 - Y2)
                               - (X4 - X2) * (Y3 - Y1)) <= 1e-4
    horizontal_parallel = np.abs((X2 - X1) * (Y4 - Y3)
                                 - (X4 - X3) * (Y2 - Y1)) <= 1e-4
    par = vertical_parallel & horizontal_parallel

    s_p, t_p = _calc_parallelogram(qlons, qlats, X1, X2, X3, X4, Y1, Y2, Y3, Y4)
    s_g, t_g = _calc_general(qlons, qlats, x0, x1, x2, x3, y0, y1, y2, y3)
    s = np.where(par, s_p, s_g)
    t = np.where(par, t_p, t_g)

    # Snap tolerance (bilinear.cpp:303-310)
    t = np.where((t >= 1) & (t <= 1.15), 1.0, t)
    t = np.where((t <= 0) & (t >= -0.15), 0.0, t)
    s = np.where((s >= 1) & (s <= 1.15), 1.0, s)
    s = np.where((s <= 0) & (s >= -0.15), 0.0, s)
    bad = inside & ~((s >= 0) & (s <= 1) & (t >= 0) & (t <= 1))
    if bad.any():
        sb = s[bad][0]
        tb = t[bad][0]
        raise RuntimeError(
            "Problem with bilinear interpolation. Grid is rotated/distorted "
            f"in a way that is not supported. s={sb} and t={tb} are outside "
            "[-0.05,1.05].")

    flat = lambda ii, jj: (ii * nx + jj).astype(np.int32)
    return BilinearMap(
        p1=flat(ii2, jj1), p2=flat(ii2, jj2), p3=flat(ii1, jj1),
        p4=flat(ii1, jj2), nn=nn.astype(np.int32),
        s=np.where(inside, s, 0.0).astype(np.float32),
        t=np.where(inside, t, 0.0).astype(np.float32),
        inside=inside)
