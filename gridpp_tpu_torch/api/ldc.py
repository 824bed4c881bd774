"""local_distribution_correction API (gridpp_tpu/api/ldc.py; reference
src/api/local_distribution_correction.cpp).

Each gridpoint's candidates are every observation within its localization
radius, in the ball query's order (api/oi._candidates with max_points 0).
The route follows the API's device (api/_common.api_device):

- host: the threaded native curve build (csrc ldc_host), its rho from the
  host evaluators the canonical shortlist uses (`_ldc_native`), bit for
  bit with gridpp_tpu's native route;
- device: ops/ldc.ldc_block over blocks of gridpoints, rho from the
  structure on the device (as gridpp_tpu's jitted route); the block's rows
  are sized from the candidates' width K x T and the bytes a (row, pair)
  element takes, so a 2000^2 grid with ~150 candidates and 24 times fits
  the card. The candidate lists are uploaded once per device.

Rows are independent, so neither the block size nor the blocks' order
changes a result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..ops.ldc import ldc_block
from ..ops.oi import _blocks
from ._common import api_device, asarray_f32, on_host, upload
from .oi import (_BLOCK, _candidate_tensors, _candidates, _device_fields,
                 _origin)

__all__ = ["local_distribution_correction"]

# bytes a (gridpoint, candidate x time) element takes on the device in
# ldc_block: the gathered pairs, rho and their masks, two stable sorts'
# keys and int64 indices, the two curves and the interpolations' compares
_ELEM_BYTES = 160
_BLOCK_BYTES = 8 << 30


def _ldc_native(bpoints, points, structure, flat_bg, cand, mask, pobs,
                pbackground, min_quantile, max_quantile, min_points):
    """Threaded C++ curve-build path (csrc ldc_host), or None.

    rho comes from the same host evaluators the canonical shortlist uses
    (native pair kernel for product-kernel structures, numpy otherwise),
    so the native and device paths see identical correlations.
    """
    from .. import native
    if native.get_lib() is None:
        return None
    from ..ops.canonical import _host_fields, _native_eval, _np_rho
    n = bpoints.size()
    origin = _origin(bpoints)
    gfx = _host_fields(bpoints, structure, origin, n)
    ofx = _host_fields(points, structure, origin, points.size())
    rho = None
    kt = _native_eval(structure)
    if kt is not None:
        rho = native.pair_rho_host(gfx, ofx, cand, mask, kt)
    if rho is None:
        rho = _np_rho(structure, gfx, ofx, np.arange(n), cand, mask)
    return native.ldc_host(flat_bg, cand, mask, rho, pobs, pbackground,
                           min_quantile, max_quantile, min_points)


def block_rows(k: int, nt: int) -> int:
    """Gridpoints a device block takes: its (rows, k x nt) working set
    within _BLOCK_BYTES, at most api/oi._BLOCK."""
    return max(1, min(_BLOCK, _BLOCK_BYTES // (max(k * nt, 1)
                                               * _ELEM_BYTES)))


def local_distribution_correction(bgrid: Grid, background, points, pobs,
                                  pbackground, structure, min_quantile,
                                  max_quantile, min_points=0):
    """Radar/crowd-sourced local quantile mapping
    (local_distribution_correction.cpp:18-203)."""
    background = asarray_f32(background)
    gy, gx = bgrid.size()
    if background.shape != (gy, gx):
        raise ValueError("Grid size is not the same as values")
    pobs = asarray_f32(pobs, "pobs")
    pbackground = asarray_f32(pbackground, "pbackground")
    if pobs.ndim == 1:
        pobs = pobs[None]
    if pbackground.ndim == 1:
        pbackground = pbackground[None]
    if pobs.shape != pbackground.shape:
        raise ValueError(
            f"pobs ({pobs.shape}) is not the same size as pbackground "
            f"({pbackground.shape})")
    if pobs.shape[1] != points.size():
        raise ValueError("Observations and points size mismatch")

    bpoints = bgrid.to_points()
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    res = _candidates(bpoints, points, loc, 0)
    flat_bg = background.reshape(-1)
    if res is None:
        return background.copy()
    cand, mask = res
    args = (bpoints, points, structure, flat_bg, cand, mask, pobs,
            pbackground, min_quantile, max_quantile, min_points)
    if on_host():
        out = _ldc_native(*args)
        if out is not None:
            return out.reshape(gy, gx)
    return _ldc_device(*args, api_device()).reshape(gy, gx)


def _ldc_device(bpoints, points, structure, flat_bg, cand, mask, pobs,
                pbackground, min_quantile, max_quantile, min_points, dev):
    """The device route on dev: ldc_block over blocks of gridpoints.
    Returns (N,) f32."""
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(points, structure, origin, dev)
    nt = pobs.shape[0]
    obs_t = upload(np.ascontiguousarray(pobs.T), dev)           # (S, T)
    fcst_t = upload(np.ascontiguousarray(pbackground.T), dev)   # (S, T)
    bg_t = upload(flat_bg, dev)
    cand_t, mask_t = _candidate_tensors(bpoints, cand, mask, dev)
    k = cand.shape[1]
    out = torch.empty_like(bg_t)
    for rows in _blocks(flat_bg.shape[0], block_rows(k, nt)):
        cb = cand_t[rows].long()
        b = cb.shape[0]
        p1 = {key: v[rows, None] for key, v in p1_all.items()}
        rho = structure.corr_background_torch(
            p1, {key: v[cb] for key, v in o_fields.items()})  # (B, K)
        out[rows] = ldc_block(
            bg_t[rows], rho.repeat_interleave(nt, dim=-1),
            mask_t[rows].repeat_interleave(nt, dim=-1),
            obs_t[cb].reshape(b, k * nt), fcst_t[cb].reshape(b, k * nt),
            float(min_quantile), float(max_quantile), int(min_points))
    return out.cpu().numpy()
