"""neighbourhood_search, smart neighbours and staticcorr_points
(gridpp_tpu/api/search.py; reference src/api/{neighbourhood_search,smart,
corr_points}.cpp).

numpy in, numpy out, on the API's device (api/_common.api_device). On the
host, neighbourhood_search takes the native conditional mean (csrc
nb_search), as gridpp_tpu's does; on the card it runs ops/search.py in
bands of rows. smart and staticcorr_points evaluate the structure against
each point's in-radius candidates (api/oi._candidates, uploaded once per
points object and device) in row blocks on the API's device and keep the
highest correlations with a stable
descending order (ops/oi._select_top: the lower candidate wins a tie, as
jax.lax.top_k does).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MV
from ..core.grid import Grid
from ..core.points import Points
from ..ops.oi import _blocks, _select_top
from ..ops.search import neighbourhood_search as search_op
from .. import native
from ._common import api_device, asarray_f32, on_host, upload
from .oi import _candidate_tensors, _candidates, _resolved_fields

__all__ = ["neighbourhood_search", "smart", "staticcorr_points"]

# bytes a (row, candidate) element takes on the device: the gathered point
# fields, rho, the masks and the sort's keys and indices
_ELEM_BYTES = 96
_BLOCK_BYTES = 1 << 31


def neighbourhood_search(array, search_array, halfwidth, search_target_min,
                         search_target_max, search_delta, apply_array=None):
    """Conditional neighbourhood mean (neighbourhood_search.cpp:7-113)."""
    if search_target_min > search_target_max:
        raise ValueError(
            "Search_target_min must be smaller than search_target_max")
    if halfwidth < 0:
        raise ValueError("halfwidth must be positive")
    array = asarray_f32(array)
    search_array = asarray_f32(search_array, "search_array")
    if search_array.shape != array.shape:
        raise ValueError("search_array must either be the same size as array")
    use_apply = apply_array is not None and np.size(apply_array) > 0
    if use_apply:
        apply_array = np.asarray(apply_array)
        if apply_array.shape != array.shape:
            raise ValueError(
                "apply_array must either be empty or same size as array")
    if on_host():
        out = native.nb_search(array, search_array, int(halfwidth),
                               float(search_target_min),
                               float(search_target_max), float(search_delta),
                               apply_array if use_apply else None)
        if out is not None:
            return out
    dev = api_device()
    out = search_op(upload(array, dev), upload(search_array, dev),
                    int(halfwidth), float(search_target_min),
                    float(search_target_max), float(search_delta),
                    upload(apply_array.astype(np.int32), dev) if use_apply
                    else None)
    return out.cpu().numpy()


def _field_tensors(pts: Points, structure, dev) -> dict:
    """The structure's resolved point fields as f32 tensors on dev (absolute
    coordinates, as gridpp_tpu's jnp arrays of them)."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=dev)
            for k, v in _resolved_fields(pts, structure).items()}


def _rho_blocks(p1_all, c_all, cand_t, corr):
    """For each row block of cand_t (N, K) on the device: (rows, its
    candidates, rho) with rho = corr(point fields, candidate fields)."""
    block = max(1, _BLOCK_BYTES // (max(cand_t.shape[1], 1) * _ELEM_BYTES))
    for rows in _blocks(cand_t.shape[0], block):
        cb = cand_t[rows].long()
        p1 = {k: v[rows, None] for k, v in p1_all.items()}
        cf = {k: v[cb] for k, v in c_all.items()}
        yield rows, cb, corr(p1, cf)


def smart(igrid: Grid, ogrid: Grid, ivalues, num, structure):
    """Mean of the `num` highest-correlation input cells within the
    localization radius (smart.cpp:12-66)."""
    ivalues = asarray_f32(ivalues)
    gy, gx = igrid.size()
    if ivalues.shape != (gy, gx):
        raise ValueError("Grid size is not the same as values")
    opoints = ogrid.to_points()
    ipoints = igrid.to_points()
    loc = structure.localization_np(opoints.lats, opoints.lons)
    res = _candidates(opoints, ipoints, loc, int(num))
    oy, ox = ogrid.size()
    if res is None:
        return np.full((oy, ox), MV, np.float32)
    cand, mask = res
    dev = api_device()
    k_sel = min(int(num), cand.shape[1])
    flat = upload(ivalues.reshape(-1), dev)
    cand_all, mask_t = _candidate_tensors(opoints, cand, mask, dev)
    out = torch.empty(cand.shape[0], dtype=torch.float32, device=dev)
    for rows, cand_t, rho in _rho_blocks(
            _field_tensors(opoints, structure, dev),
            _field_tensors(ipoints, structure, dev), cand_all,
            structure.corr_torch):
        _, sel, sel_valid = _select_top(rho, mask_t[rows], k_sel)
        vals = flat[torch.gather(cand_t, 1, sel)]
        count = torch.sum(sel_valid, dim=1)
        total = torch.sum(torch.where(sel_valid, vals, 0.0), dim=1)
        out[rows] = torch.where(count > 0,
                                total / torch.clamp(count, min=1), torch.nan)
    return out.cpu().numpy().reshape(oy, ox)


def staticcorr_points(points: Points, knots: Points, structure, max_points):
    """Dense (points x knots) localized correlation rows
    (corr_points.cpp:26-130)."""
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    if points.get_coordinate_type() != knots.get_coordinate_type():
        raise ValueError(
            "Both background grid and observations points must be of same "
            "coordinate type (lat/lon or x/y)")
    ny = points.size()
    ns = knots.size()
    if ns == 0 or ny == 0:
        return np.zeros((ny, ns), np.float32)
    loc = structure.localization_np(points.lats, points.lons)
    res = _candidates(points, knots, loc, int(max_points))
    if res is None:
        return np.zeros((ny, ns), np.float32)
    cand, mask = res
    dev = api_device()
    k_sel = min(int(max_points), cand.shape[1]) if max_points > 0 \
        else cand.shape[1]
    cand_all, mask_t = _candidate_tensors(points, cand, mask, dev)
    output = torch.zeros((ny, ns), dtype=torch.float32, device=dev)
    for rows, cand_t, rho in _rho_blocks(
            _field_tensors(points, structure, dev),
            _field_tensors(knots, structure, dev), cand_all,
            structure.corr_background_torch):
        vals, sel, sel_valid = _select_top(
            rho, mask_t[rows] & (rho > 0), k_sel)
        idx = torch.gather(cand_t, 1, sel)
        row = torch.arange(rows.start, rows.stop, device=dev)[:, None]
        output[row.expand_as(idx)[sel_valid], idx[sel_valid]] = \
            vals[sel_valid]
    return output.cpu().numpy()
