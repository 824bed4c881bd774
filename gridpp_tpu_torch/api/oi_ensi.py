"""Ensemble OI API (gridpp_tpu/api/oi_ensi.py, reference
src/api/oi_ensi.cpp).

Routes as in api/oi.py. Host: the threaded native EnSI solver (csrc
oi_ensi_host_solve) for the product-kernel structures, the plain torch
`ensi_kernel` on CPU tensors for the others. Device: the canonical
shortlist sweep (the EnsiPipeline's `_sweep`); when a truncated row is
starved this cycle, the dense all-obs sweep for moderate networks, else
`ensi_kernel` on host-fed candidates on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..ops.oi import shortlist_starved
from ..ops.oi_ensi import (ensi_dense_sweep, ensi_kernel,
                           ensi_shortlist_sweep, obs_anomalies)
from . import oi as _oi
from ._common import api_device, asarray_f32, on_host
from .oi import (_BALL_QUERY_MAX, _BLOCK, _candidates, _candidates_block,
                 _device_fields, _host_arrays, _origin, _shortlist_dev,
                 _with_scales)

__all__ = ["optimal_interpolation_ensi"]


def _valid_members(*arrays):
    """Indices of the members (columns) finite in every row of each (., E)
    array (oi_ensi.cpp:188-201). A whole-array check runs first: when
    every value is finite, the usual case, no per-column pass is made."""
    ok = np.ones(arrays[0].shape[1], bool)
    for a in arrays:
        if not np.isfinite(a).all():
            ok &= np.isfinite(a).all(axis=0)
    return np.nonzero(ok)[0]


def _members(a, valid_ens):
    """a[:, valid_ens], without the copy when every member is valid."""
    return a if valid_ens.size == a.shape[1] else a[:, valid_ens]


def _with_members(flat_bg, valid_ens, out_valid):
    """flat_bg with the valid members' columns replaced by their analysis
    out_valid; out_valid itself when every member is valid."""
    if valid_ens.size == flat_bg.shape[1]:
        return out_valid
    output = flat_bg.copy()
    output[:, valid_ens] = out_valid
    return output


def _warn_condition(count: int):
    """Report ill-conditioned gridpoints (oi_ensi.cpp:557-561)."""
    if count > 0:
        from .. import warning
        warning(f"Condition number error in {count} points. "
                "Using raw values in those points.")


def optimal_interpolation_ensi(bgrid, background, points, pobs, psigmas,
                               pbackground, structure, max_points,
                               allow_extrapolation=True):
    """Ensemble OI / local ensemble transform (oi_ensi.cpp:33-568).

    Grid form: background (Y, X, E), returns (Y, X, E).
    Points form: background (P, E), returns (P, E).
    """
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    if bgrid.get_coordinate_type() != points.get_coordinate_type():
        raise ValueError(
            "Both background and observations points must be of same "
            "coorindate type (lat/lon or x/y)")
    background = asarray_f32(background, "background")
    pobs = asarray_f32(pobs, "pobs").ravel()
    psigmas = asarray_f32(psigmas, "psigmas").ravel()
    pbackground = asarray_f32(pbackground, "pbackground")
    is_grid = isinstance(bgrid, Grid)
    if is_grid:
        gy, gx = bgrid.size()
        if background.ndim != 3 or background.shape[:2] != (gy, gx):
            raise ValueError("Input field is not the same size as the grid")
        bpoints = bgrid.to_points()
        flat_bg = background.reshape(gy * gx, -1)
    else:
        bpoints = bgrid
        if background.ndim != 2 or background.shape[0] != bgrid.size():
            raise ValueError("Input field is not the same size as the grid")
        flat_bg = background
    if pobs.shape[0] != points.size():
        raise ValueError("Observations and points exception mismatch")
    if psigmas.shape[0] != points.size():
        raise ValueError("Sigmas and points size mismatch")
    if pbackground.ndim != 2 or pbackground.shape[0] != points.size():
        raise ValueError("Background and points size mismatch")

    n, n_ens = flat_bg.shape
    ns = points.size()
    if ns == 0 or n_ens == 0:
        return flat_bg.copy().reshape(background.shape)

    # Valid-member screening: member valid at every gridpoint
    # (oi_ensi.cpp:188-201)
    valid_ens = _valid_members(flat_bg)
    if valid_ens.size == 0:
        return flat_bg.copy().reshape(background.shape)

    # Pre-filter observations with invalid values (oi_ensi.cpp:229-236
    # checks pobs only)
    keep = np.isfinite(pobs)
    if not keep.any():
        return flat_bg.copy().reshape(background.shape)
    kidx = np.nonzero(keep)[0]
    opts = points.subset(kidx)
    bg_valid = _members(flat_bg, valid_ens)

    def finish(out_valid, n_cond):
        _warn_condition(n_cond)
        return _with_members(flat_bg, valid_ens, out_valid).reshape(
            background.shape)

    # Canonical-shortlist device route: the selection of the serving
    # pipelines and the native solver (ops/canonical.py); full-depth paths
    # below when a truncated row is starved this cycle.
    if not host and max_points > 0:
        res_sl = _ensi_shortlist(
            bpoints, bg_valid, valid_ens, points, pobs, psigmas,
            pbackground, structure, max_points, allow_extrapolation, dev)
        if res_sl is not None:
            return finish(*res_sl)

    # Anomaly decomposition at obs points (oi_ensi.cpp:166-178)
    with np.errstate(invalid="ignore"):
        y_hat = np.nanmean(np.where(np.isfinite(pbackground), pbackground,
                                    np.nan), axis=1)
    y_anom = np.where(np.isfinite(pbackground) & np.isfinite(y_hat[:, None]),
                      pbackground - y_hat[:, None], pbackground)
    obs_k = pobs[kidx]
    sig_k = psigmas[kidx]
    yhat_k = y_hat[kidx].astype(np.float32)
    yanom_k = np.ascontiguousarray(_members(y_anom[kidx], valid_ens),
                                   np.float32)

    # Dense device route: rho against every valid obs on the device; on
    # the host the cached tree query is far cheaper (see api/oi.py)
    if (not host and 0 < opts.size() <= 32768
            and n * opts.size() > 4_000_000):
        return finish(*_ensi_dense(
            bpoints, opts, structure, bg_valid, obs_k, sig_k, yanom_k,
            yhat_k, max_points, allow_extrapolation, dev))

    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    # Large host grids: per-block exact ball queries with bounded memory
    # (see api/oi.py _candidates_block); otherwise one global query.
    chunked = host and n > _BALL_QUERY_MAX
    cand = mask = None
    if not chunked:
        res = _candidates(bpoints, opts, loc, max_points)
        if res is None:
            return flat_bg.copy().reshape(background.shape)
        cand, mask = res
    obs_key = (opts.size(), hash(opts.lats.tobytes()),
               hash(opts.lons.tobytes()),
               float(loc.min()) if loc.size else 0.0,
               float(loc.max()) if loc.size else 0.0)

    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(opts, structure, origin, dev)

    # Threaded native solver (double-precision local algebra like the
    # reference's Armadillo path) for the product-kernel structures; the
    # reference's EnSI is single-threaded (OMP disabled,
    # oi_ensi.cpp:203-206).
    kt = _oi._native_kernel_type(structure)
    if host and kt is not None:
        res_nat = _ensi_native(
            bpoints, opts, loc, structure, kt, _host_arrays(p1_all),
            _host_arrays(o_fields), obs_k, sig_k, yhat_k, yanom_k,
            bg_valid, max_points, allow_extrapolation, chunked, cand, mask,
            obs_key)
        if res_nat is not None:
            return finish(*res_nat)

    def t(a):
        return torch.as_tensor(a, device=dev)

    t_obs, t_sig, t_yanom, t_yhat = t(obs_k), t(sig_k), t(yanom_k), t(yhat_k)
    bg_t = t(np.ascontiguousarray(bg_valid))
    out_t = bg_t.clone()
    n_cond = torch.zeros((), dtype=torch.int64, device=dev)
    # Adaptive block: the (B, K, E) gathers and the batched transform must
    # fit beside the field arrays
    k_pad = cand.shape[1] if cand is not None else 128
    e_val = max(len(valid_ens), 1)
    block = max(16384, min(_BLOCK, (1 << 27) // max(k_pad * e_val, 1)))
    for start in range(0, n, block):
        end = min(start + block, n)
        if chunked:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:
                continue
            cand_b, mask_b = res_b
        else:
            cand_b, mask_b = cand[start:end], mask[start:end]
        cand_t = t(cand_b).long()
        p1 = {k: v[start:end, None] for k, v in p1_all.items()}
        cand_fields = {k: v[cand_t] for k, v in o_fields.items()}
        out_t[start:end], cond_b = ensi_kernel(
            structure, p1, cand_fields, t(mask_b), bg_t[start:end],
            t_obs[cand_t], t_sig[cand_t], t_yanom[cand_t], t_yhat[cand_t],
            int(max_points), bool(allow_extrapolation))
        n_cond += cond_b.sum()
    return finish(out_t.cpu().numpy(), int(n_cond))


def _ensi_shortlist(bpoints, bg_valid, valid_ens, points, pobs, psigmas,
                    pbackground, structure, max_points, allow_extrapolation,
                    dev):
    """Device EnSI from the canonical shortlist; (analysis of the valid
    members, n_cond) or None when a starved row demands the full-depth
    path.

    The obs-point mean and anomalies are computed on the device by the
    EnsiPipeline's own `obs_anomalies`, and the sweep is its `_sweep`, so
    on the same inputs the two agree bit for bit."""
    n_obs = points.size()
    k_cap = min(n_obs, max(2 * int(max_points), 16))
    s_cap = min(int(max_points), k_cap)
    sel, rho, valid, truncated, sl = _shortlist_dev(bpoints, points,
                                                    structure, k_cap, dev)
    obs_t = torch.as_tensor(pobs, device=dev)
    if int(shortlist_starved(sel, valid, truncated, torch.isfinite(obs_t),
                             s_cap)):
        return None
    y_hat, y_anom = obs_anomalies(torch.as_tensor(pbackground, device=dev))
    e = max(len(valid_ens), 1)
    block = max(8192, min(_BLOCK, (1 << 27) // max(32 * e, 1),
                          (1 << 27) // max(sl.k_cap, 1)))
    out, cond_bad = ensi_shortlist_sweep(
        sel, rho, valid, torch.as_tensor(np.ascontiguousarray(bg_valid),
                                         device=dev),
        obs_t, torch.as_tensor(psigmas, device=dev),
        y_anom if valid_ens.size == y_anom.shape[1]
        else y_anom[:, torch.as_tensor(valid_ens, device=dev)].contiguous(),
        y_hat, int(max_points), bool(allow_extrapolation), block)
    return out.cpu().numpy(), int(cond_bad.sum())


def _ensi_dense(bpoints, opts, structure, bg_valid, obs_k, sig_k, yanom_k,
                yhat_k, max_points, allow_extrapolation, dev):
    """Device EnSI with rho against every valid obs; (analysis of the
    valid members, n_cond)."""
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(opts, structure, origin, dev)
    p = opts.size()
    e_val = max(bg_valid.shape[1], 1)
    block = max(8192, min(_BLOCK, (1 << 28) // max(p, 1),
                          (1 << 27) // max(32 * e_val, 1)))
    out, cond_bad = ensi_dense_sweep(
        structure, p1_all, o_fields,
        *(torch.as_tensor(np.ascontiguousarray(a), device=dev)
          for a in (bg_valid, obs_k, sig_k, yanom_k, yhat_k)),
        int(max_points), bool(allow_extrapolation), block)
    return out.cpu().numpy(), int(cond_bad.sum())


def _ensi_native(bpoints, opts, loc, structure, kt, p1_np, o_np, obs_k,
                 sig_k, yhat_k, yanom_k, bg_valid, max_points,
                 allow_extrapolation, chunked, cand, mask, obs_key):
    """Run the threaded native EnSI solve; (analysis, n_cond) or None."""
    from .. import native
    if native.get_lib() is None:
        return None
    n = bpoints.size()

    gfx = _with_scales(p1_np, structure, n)
    gfx["loc"] = np.asarray(loc, np.float32)
    ofx = _with_scales(o_np, structure, opts.size())
    ofx["loc"] = np.asarray(
        structure.localization_np(opts.lats, opts.lons), np.float32)
    bg_valid = np.ascontiguousarray(bg_valid, np.float32)

    if not chunked:
        res = native.oi_ensi_host_solve(
            gfx, ofx, obs_k, sig_k, yhat_k, yanom_k, cand, mask, kt,
            int(max_points), bool(allow_extrapolation), bg_valid)
        if res is None:
            return None
        return res[0], int(res[1].sum())

    # canonical-shortlist feed when cheaper than per-block ball queries
    # (same exactness argument and gate as the deterministic path:
    # api/oi.py _chunked_shortlist)
    sl = _oi._chunked_shortlist(bpoints, opts, structure, loc, max_points,
                                n)

    out = bg_valid.copy()
    n_cond = 0
    for start in range(0, n, _BLOCK):
        end = min(start + _BLOCK, n)
        if sl is not None:
            res_b = (sl.sel[start:end], sl.valid[start:end])
        else:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:
                continue
        gfb = {k: v[start:end] for k, v in gfx.items()}
        res = native.oi_ensi_host_solve(
            gfb, ofx, obs_k, sig_k, yhat_k, yanom_k, res_b[0], res_b[1],
            kt, int(max_points), bool(allow_extrapolation),
            bg_valid[start:end])
        if res is None:
            return None
        out[start:end] = res[0]
        n_cond += int(res[1].sum())
    return out, n_cond
