"""fill, fill_missing, doping (gridpp_tpu/api/fill.py; reference
src/api/{fill,doping}.cpp).

Host code on every route, as in gridpp_tpu: point-ordered overwrites
(later points win, like the reference's serial loops) through the native
index's circle paint and square doping where the native library builds,
else vectorized numpy and scipy radius queries.
"""
from __future__ import annotations

import numpy as np

from ..constants import MV
from ..core.grid import Grid
from ..core.points import Points
from .. import native
from ._common import asarray_f32, check_grid_compatible

__all__ = ["fill", "fill_missing", "doping_square", "doping_circle"]


def fill(igrid: Grid, input, points: Points, radii, value, outside):
    """Paint `value` inside (outside=False) or outside (True) the circles
    around each point (fill.cpp:6-41)."""
    input = asarray_f32(input)
    check_grid_compatible(igrid, input)
    radii = asarray_f32(radii, "radii").ravel()
    if points.size() != radii.size:
        raise ValueError("Points size is not the same as radii size")
    if np.any(radii < 0):
        raise ValueError("All radius sizes must be 0 or greater")
    ny, nx = input.shape
    if outside:
        output = np.full_like(input, value)
    else:
        output = input.copy()
    flat_out = output.reshape(-1)
    flat_in = np.ascontiguousarray(input.reshape(-1))
    # Per-point radii: query each circle (order matters for overwrites)
    from ..core.coords import convert_coordinates_np
    x, y, z = convert_coordinates_np(points.lats, points.lons,
                                     igrid.get_coordinate_type())
    q = np.stack([np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(z)],
                 axis=-1)
    nat = igrid.index.native
    if nat is not None:
        if outside:
            nat.paint(q, radii, flat_out, src=flat_in)
        else:
            nat.paint(q, radii, flat_out,
                      values=np.full(points.size(), value, np.float32))
        return output
    tree = igrid.index.tree
    for i in range(points.size()):
        idx = np.asarray(tree.query_ball_point(q[i], r=float(radii[i])),
                         dtype=np.int64)
        if outside:
            flat_out[idx] = flat_in[idx]
        else:
            flat_out[idx] = value
    return output


def fill_missing(values):
    """Fill NaN holes by averaging 1-D linear interpolation along x and y
    (fill.cpp:43-134)."""
    values = asarray_f32(values)
    if values.ndim != 2:
        raise ValueError("values must be 2D")

    def interp_1d(v):
        # v: (rows, n); returns per-row linear interpolation across gaps
        rows, n = v.shape
        valid = np.isfinite(v)
        idx = np.arange(n)
        # last valid index at or before x (leading gap -> index 0, whose
        # value is invalid -> NaN result, matching the reference)
        last = np.where(valid, idx, -1)
        last = np.maximum.accumulate(last, axis=1)
        has_last = last >= 0
        last = np.where(has_last, last, 0)
        # next valid index at or after x (trailing gap -> none -> MV)
        nxt = np.where(valid, idx, n)
        nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
        has_next = nxt < n
        nxt_c = np.where(has_next, nxt, n - 1)
        r = np.arange(rows)[:, None]
        v_last = v[r, last]
        v_next = v[r, nxt_c]
        denom = np.where(nxt_c == last, 1, nxt_c - last)
        with np.errstate(invalid="ignore"):
            interp = v_last + (v_next - v_last) * (idx[None, :] - last) / denom
        out = np.where(valid, v, np.where(has_next, interp, np.nan))
        return out

    ry = interp_1d(values)
    rx = interp_1d(values.T).T
    vy = np.isfinite(ry)
    vx = np.isfinite(rx)
    total = np.where(vy, ry, 0) + np.where(vx, rx, 0)
    count = vy.astype(np.int32) + vx.astype(np.int32)
    return np.where(count > 0, total / np.maximum(count, 1),
                    MV).astype(np.float32)


def _doping_common(igrid, background, points, observations, per_point,
                   max_elev_diff, name):
    background = asarray_f32(background)
    check_grid_compatible(igrid, background)
    observations = asarray_f32(observations, "observations").ravel()
    if points.size() != observations.size:
        raise ValueError("Points size is not the same as observations size")
    per_point = np.asarray(per_point).ravel()
    if points.size() != per_point.size:
        raise ValueError(f"Points size is not the same as {name} size")
    if np.isfinite(max_elev_diff) and max_elev_diff < 0:
        raise ValueError(
            "max_elev_diff must be greater than or equal to 0")
    return background.copy(), observations, per_point


def doping_square(igrid: Grid, background, points: Points, observations,
                  halfwidth, max_elev_diff=MV):
    """Insert observations over square footprints (doping.cpp:5-48)."""
    output, obs, hw = _doping_common(igrid, background, points, observations,
                                     halfwidth, max_elev_diff, "halfwidth")
    hw = hw.astype(np.int64)
    if np.any(hw < 0):
        raise ValueError(
            "All halfwidth must be greater than or equal to 0")
    ny, nx = output.shape
    check_elev = np.isfinite(max_elev_diff)
    # the obs->cell map is pure geometry: cache per (grid, points) like
    # the downscaling ops and gridding_nearest
    nn = igrid.nearest_map(points.lats, points.lons,
                           cache_obj=points).astype(np.int64)
    n_pts = points.size()
    if n_pts == 0:
        return output
    cy, cx = np.divmod(nn, nx)

    if output.flags.c_contiguous and native.doping_square(
            cy, cx, obs, hw, points.elevs, igrid.elevs, ny, nx,
            bool(check_elev), float(max_elev_diff) if check_elev else 0.0,
            output):
        return output

    def _pairs(sel, w):
        """(cells, point_ids) for every (point, footprint-cell) pair of the
        selected points, point-major (C ravel order preserves the
        reference's serial overwrite order: doping.cpp:5-48)."""
        d = np.arange(-w, w + 1, dtype=np.int64)
        yy = np.clip(cy[sel, None, None] + d[None, :, None], 0, ny - 1)
        xx = np.clip(cx[sel, None, None] + d[None, None, :], 0, nx - 1)
        cells = (yy * nx + xx).reshape(len(sel), -1)
        pids = np.broadcast_to(sel[:, None], cells.shape)
        return cells.ravel(), pids.ravel()

    uniq = np.unique(hw)
    if uniq.size == 1:
        cells, pids = _pairs(np.arange(n_pts), int(uniq[0]))
    else:
        parts = [_pairs(np.nonzero(hw == w)[0], int(w)) for w in uniq]
        cells = np.concatenate([p[0] for p in parts])
        pids = np.concatenate([p[1] for p in parts])
        # Restore global point order so that later points overwrite
        order = np.argsort(pids, kind="stable")
        cells = cells[order]
        pids = pids[order]
    if check_elev:
        ok = np.abs(points.elevs[pids]
                    - igrid.elevs.reshape(-1)[cells]) <= max_elev_diff
        cells = cells[ok]
        pids = pids[ok]
    # Sequential fancy assignment: duplicate cells resolve to the LAST
    # pair, i.e. the highest point index - the reference's loop order
    output.reshape(-1)[cells] = obs[pids]
    return output


def doping_circle(igrid: Grid, background, points: Points, observations,
                  radii, max_elev_diff=MV):
    """Insert observations over circular footprints (doping.cpp:50-93)."""
    output, obs, radii = _doping_common(igrid, background, points,
                                        observations, radii, max_elev_diff,
                                        "radii")
    if np.any(radii < 0):
        raise ValueError("radii must be greater than or equal to 0")
    ny, nx = output.shape
    check_elev = np.isfinite(max_elev_diff)
    flat_out = output.reshape(-1)
    flat_elev = igrid.elevs.reshape(-1)
    from ..core.coords import convert_coordinates_np
    x, y, z = convert_coordinates_np(points.lats, points.lons,
                                     igrid.get_coordinate_type())
    q = np.stack([np.atleast_1d(x), np.atleast_1d(y), np.atleast_1d(z)],
                 axis=-1)
    nat = igrid.index.native
    if nat is not None:
        nat.paint(q, radii, flat_out, values=obs,
                  pelev=points.elevs if check_elev else None,
                  gelev=flat_elev if check_elev else None,
                  max_diff=float(max_elev_diff) if check_elev else 0.0)
        return output
    tree = igrid.index.tree
    for i in range(points.size()):
        idx = np.asarray(tree.query_ball_point(q[i], r=float(radii[i])),
                         dtype=np.int64)
        if check_elev and idx.size:
            idx = idx[np.abs(points.elevs[i] - flat_elev[idx])
                      <= max_elev_diff]
        flat_out[idx] = obs[i]
    return output
