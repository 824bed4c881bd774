"""Multi-variant ensemble OI API (gridpp_tpu/api/oi_ensi_multi.py,
reference src/api/oi_ensi_multi.cpp).

Grid and points forms for the ebe / ebesc / utem schemes. Routes as in
api/oi.py. Host: the threaded native solvers (csrc oi_member_host_solve,
oi_utem_host_solve) for the product-kernel structures, the plain torch
`ebe_kernel`/`ebesc_kernel`/`utem_kernel` on CPU tensors for the others.
Device: the canonical-shortlist sweeps of the MultiEnsiPipeline
(`member_serve_sweep`, `utem_serve_sweep`, with its per-obs tables built
on the device by the same code); when a truncated row is starved this
cycle, the host-candidate kernels on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..ops.oi import shortlist_starved
from ..ops.oi_ensi_multi import (DEFAULT_MIN_STD, ebe_kernel, ebesc_kernel,
                                 member_serve_sweep, member_table,
                                 norm_anom, utem_kernel, utem_serve_sweep,
                                 utem_table)
from . import oi as _oi
from ._common import api_device, asarray_f32, on_host
from .oi import (_BLOCK, _candidates, _device_fields, _host_arrays, _origin,
                 _shortlist_dev)
from .oi_ensi import (_members, _valid_members, _warn_condition,
                      _with_members)

__all__ = [
    "optimal_interpolation_ensi_multi_ebe",
    "optimal_interpolation_ensi_multi_ebesc",
    "optimal_interpolation_ensi_multi_utem",
]

# Gridpoints per batch of the shortlist sweeps: the ensemble pipelines'
# default block
_SERVE_BLOCK = 1 << 20


def _flatten_grid(bgrid, background, name):
    if isinstance(bgrid, Grid):
        gy, gx = bgrid.size()
        if background.ndim != 3 or background.shape[:2] != (gy, gx):
            raise ValueError(f"Input {name} field is not the same size as "
                             "the grid")
        return bgrid.to_points(), background.reshape(gy * gx, -1), True
    if background.ndim != 2 or background.shape[0] != bgrid.size():
        raise ValueError(f"Input {name} field is not the same size as the "
                         "grid")
    return bgrid, background, False


def _norm_anom(arr, valid_ens):
    """Normalized anomalies 1/sqrt(E-1)*(v-mean)/std, zeroed for tiny or
    invalid std (oi_ensi_multi.cpp:421-445), in float64 on the host."""
    v = arr[:, valid_ens].astype(np.float64)
    e = v.shape[1]
    mean = v.mean(axis=1)
    std = v.std(axis=1)
    bad = ~np.isfinite(mean) | ~np.isfinite(std) | (std <= DEFAULT_MIN_STD)
    denom = np.where(std == 0, 1, std)
    out = (v - mean[:, None]) / denom[:, None] / np.sqrt(max(e - 1, 1))
    out[bad] = 0.0
    return out.astype(np.float32)


def _common_prep(bpoints, points, structure, max_points, obs_select_valid,
                 dev):
    keep = np.nonzero(obs_select_valid)[0]
    if keep.size == 0:
        return None
    opts = points.subset(keep)
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    res = _candidates(bpoints, opts, loc, max_points)
    if res is None:
        return None
    cand, mask = res
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(opts, structure, origin, dev)
    return keep, cand, mask, p1_all, o_fields, loc


def _run_blocks(kernel, n, cand, mask, p1_all, o_fields, per_block_args,
                n_ens, dev):
    """kernel(p1, cand_fields, cand_valid, *per_block_args(start, end,
    cand)) over blocks of gridpoints on `dev`; the condition failures are
    summed on the device and read once."""
    outs = []
    n_cond = None
    k_pad = cand.shape[1]
    block = max(16384, min(_BLOCK, (1 << 27) // max(k_pad * n_ens, 1)))
    for start in range(0, n, block):
        end = min(start + block, n)
        cand_t = torch.as_tensor(cand[start:end], device=dev).long()
        p1 = {k: v[start:end, None] for k, v in p1_all.items()}
        cand_fields = {k: v[cand_t] for k, v in o_fields.items()}
        out = kernel(p1, cand_fields,
                     torch.as_tensor(mask[start:end], device=dev),
                     *per_block_args(start, end, cand_t))
        if isinstance(out, tuple):  # (analysis, cond_bad) kernels
            out, cond_bad = out
            n_cond = cond_bad.sum() if n_cond is None \
                else n_cond + cond_bad.sum()
        outs.append(out)
    if n_cond is not None:
        _warn_condition(int(n_cond))
    return torch.cat(outs).cpu().numpy()


def _validate_multi(bpoints_obj, points, n_ens, pobs, pratios,
                    pbackground, extra=(), pobs_1d=False):
    """Up-front shape validation (oi_ensi_multi.cpp:34-133, 329-420).

    All malformed inputs raise ValueError (the reference throws
    std::invalid_argument before touching any data), including wrong
    ndim: ebe/ebesc take perturbed obs as (S, E), utem as (S,).
    """
    if bpoints_obj.get_coordinate_type() != points.get_coordinate_type():
        raise ValueError(
            "Both background and observations points must be of same "
            "coorindate type (lat/lon or x/y)")
    ns = points.size()
    if pobs_1d:
        if pobs.ndim != 1 or pobs.shape[0] != ns:
            raise ValueError(
                f"Observations {pobs.shape} and points ({ns},) size "
                "mismatch")
    else:
        if pobs.ndim != 2 or pobs.shape != (ns, n_ens):
            raise ValueError(
                f"Observations {pobs.shape} and points ({ns},{n_ens}) "
                "size mismatch")
    if pratios.ndim != 1 or pratios.shape[0] != ns:
        raise ValueError(f"Ratios ({pratios.shape}) and points ({ns}) "
                         "size mismatch")
    if pbackground.ndim != 2 or pbackground.shape != (ns, n_ens):
        raise ValueError(
            f"Input pbackground field at observation location "
            f"{pbackground.shape} and points ({ns},{n_ens}) size mismatch")
    for arr, name in extra:
        if arr.ndim != 2 or arr.shape != (ns, n_ens):
            raise ValueError(f"Input {name} field at observation location "
                             f"{arr.shape} and points ({ns},{n_ens}) size "
                             "mismatch")


def _native_member_geom(bpoints, points, keep, structure, p1_all,
                        o_fields, loc):
    """gfx/ofx field dicts (+ per-point scales and localization) for the
    native ensi_multi solvers. `loc` is the grid localization already
    computed by _common_prep (recomputing it costs an uncached
    full-grid nearest query for spatial structures)."""
    n = bpoints.size()
    gfx = _oi._with_scales(_host_arrays(p1_all), structure, n)
    gfx["loc"] = np.asarray(loc, np.float32)
    opts = points.subset(keep)
    ofx = _oi._with_scales(_host_arrays(o_fields), structure, opts.size())
    ofx["loc"] = np.asarray(
        structure.localization_np(opts.lats, opts.lons), np.float32)
    return gfx, ofx


def _native_ready(structure, host):
    """Native kernel id when the threaded host solver applies, else
    None (see api/oi.py _native_kernel_type)."""
    if not host:
        return None
    kt = _oi._native_kernel_type(structure)
    if kt is None:
        return None
    from .. import native
    if native.get_lib() is None:
        return None
    return kt


def _multi_shortlist_prep(bpoints, points, structure, max_points, obs_ok,
                          dev):
    """The canonical shortlist's (sel, rho, valid) on `dev` and s_cap, or
    None when the shortlist route does not apply this cycle (no obs, no
    cap, or a starved row). obs_ok: (P,) bool tensor on `dev`."""
    n_obs = points.size()
    if n_obs == 0 or max_points <= 0:
        return None
    k_cap = min(n_obs, max(2 * int(max_points), 16))
    s_cap = min(int(max_points), k_cap)
    sel, rho, valid, truncated, _ = _shortlist_dev(bpoints, points,
                                                   structure, k_cap, dev)
    if int(shortlist_starved(sel, valid, truncated, obs_ok, s_cap)):
        return None
    return (sel, rho, valid), s_cap


def _member_shortlist(bpoints, points, structure, max_points, allow,
                      bg_v, flat_ratios, pobs, pratios, pbackground,
                      valid_ens, dev, flat_bgc=None, pbackground_corr=None):
    """Canonical-shortlist device route for ebe/ebesc: the
    MultiEnsiPipeline's cycle (member_table, member_serve_sweep) fed with
    the API's own per-obs arrays. Returns analysis columns or None."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    pobs_t = t(pobs)
    prep = _multi_shortlist_prep(bpoints, points, structure, max_points,
                                 torch.isfinite(pobs_t[:, 0]), dev)
    if prep is None:
        return None
    cand, s_cap = prep
    o_fields = _device_fields(points, structure, _origin(bpoints), dev)
    field_keys = tuple(o_fields)
    cols = torch.as_tensor(valid_ens, device=dev)
    use_z = flat_bgc is not None
    tab = member_table(
        torch.stack([o_fields[k] for k in field_keys], dim=1), t(pratios),
        pobs_t[:, cols] - t(pbackground)[:, cols],
        t(pbackground_corr)[:, cols] if use_z else None)
    out = member_serve_sweep(
        structure, field_keys, t(bg_v), t(flat_ratios),
        norm_anom(t(_members(flat_bgc, valid_ens))) if use_z else None, tab,
        torch.isfinite(pobs_t[:, 0]), cand, s_cap, _SERVE_BLOCK,
        bool(allow))
    return out.cpu().numpy()


def _utem_shortlist(bpoints, points, structure, max_points, allow, bg_v,
                    bgc_v, flat_ratios, pobs, pratios, pbackground,
                    pbackground_corr, valid_ens, dev):
    """Canonical-shortlist device route for utem (utem_table,
    utem_serve_sweep). Returns (analysis columns, n_cond) or None."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    pobs_t = t(pobs)
    obs_ok = torch.isfinite(pobs_t)
    prep = _multi_shortlist_prep(bpoints, points, structure, max_points,
                                 obs_ok, dev)
    if prep is None:
        return None
    cand, s_cap = prep
    tab = utem_table(pobs_t, t(pratios), t(pbackground[:, valid_ens]),
                     t(pbackground_corr[:, valid_ens]))
    out, n_cond = utem_serve_sweep(t(bg_v), t(bgc_v), t(flat_ratios), tab,
                                   obs_ok, cand, s_cap, _SERVE_BLOCK,
                                   bool(allow))
    return out.cpu().numpy(), int(n_cond)


def optimal_interpolation_ensi_multi_ebe(bgrid, bratios, background,
                                         background_corr, points, pobs,
                                         pratios, pbackground,
                                         pbackground_corr, structure,
                                         max_points,
                                         allow_extrapolation=True):
    """Member-by-member update with ensemble-derived correlations
    (oi_ensi_multi.cpp:329-627)."""
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background)
    background_corr = asarray_f32(background_corr, "background_corr")
    bratios = asarray_f32(bratios, "bratios")
    pobs = asarray_f32(pobs, "pobs")
    pratios = asarray_f32(pratios, "pratios")
    pbackground = asarray_f32(pbackground, "pbackground")
    pbackground_corr = asarray_f32(pbackground_corr, "pbackground_corr")
    bpoints, flat_bg, is_grid = _flatten_grid(bgrid, background,
                                              "background")
    _, flat_bgc, _ = _flatten_grid(bgrid, background_corr,
                                   "background_corr")
    n, n_ens = flat_bg.shape
    if flat_bgc.shape != flat_bg.shape:
        raise ValueError("Input background_corr field is not the same "
                         "size as the grid")
    flat_ratios = bratios.ravel()
    if flat_ratios.shape[0] != bpoints.size():
        raise ValueError("Bratios and grid size mismatch")
    _validate_multi(bpoints, points, n_ens, pobs, pratios, pbackground,
                    [(pbackground_corr, "pbackground_corr")])
    if points.size() == 0 or n_ens == 0:
        return flat_bg.copy().reshape(background.shape)

    valid_ens = _valid_members(flat_bg, flat_bgc, pbackground,
                               pbackground_corr)
    if valid_ens.size == 0:
        return flat_bg.copy().reshape(background.shape)

    # Canonical-shortlist device route (selection shared with the
    # pipelines and native solvers, ops/canonical.py); the full-depth
    # paths on the host or on starved rows.
    if not host:
        out_sl = _member_shortlist(
            bpoints, points, structure, max_points, allow_extrapolation,
            _members(flat_bg, valid_ens), flat_ratios, pobs, pratios,
            pbackground, valid_ens, dev, flat_bgc, pbackground_corr)
        if out_sl is not None:
            return _with_members(flat_bg, valid_ens, out_sl).reshape(
                background.shape)

    prep = _common_prep(bpoints, points, structure, max_points,
                        np.isfinite(pobs[:, 0]), dev)
    if prep is None:
        return flat_bg.copy().reshape(background.shape)
    keep, cand, mask, p1_all, o_fields, loc = prep

    z_r = _norm_anom(pbackground_corr, valid_ens)[keep]
    x_l = _norm_anom(flat_bgc, valid_ens)
    innov = (pobs[:, valid_ens] - pbackground[:, valid_ens])[keep]

    kt = _native_ready(structure, host)
    if kt is not None:
        from .. import native
        gfx, ofx = _native_member_geom(bpoints, points, keep, structure,
                                       p1_all, o_fields, loc)
        out_nat = native.oi_member_host_solve(
            gfx, ofx, pratios[keep], innov.astype(np.float32), z_r, x_l,
            flat_ratios, cand, mask, kt, int(max_points),
            bool(allow_extrapolation), True, _members(flat_bg, valid_ens))
        if out_nat is not None:
            return _with_members(flat_bg, valid_ens, out_nat).reshape(
                background.shape)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    t_ratios, t_innov, t_zr = (t(pratios[keep]), t(innov.astype(np.float32)),
                               t(z_r))
    bg_t, br_t = t(_members(flat_bg, valid_ens)), t(flat_ratios)
    xl_t = t(x_l)

    def kernel(p1, cf, cv, *args):
        return ebe_kernel(structure, p1, cf, cv, *args, int(max_points),
                          bool(allow_extrapolation))

    def per_block(start, end, cand_t):
        return (bg_t[start:end], br_t[start:end], xl_t[start:end],
                t_ratios[cand_t], t_innov[cand_t], t_zr[cand_t])

    out = _run_blocks(kernel, n, cand, mask, p1_all, o_fields, per_block,
                      len(valid_ens), dev)
    return _with_members(flat_bg, valid_ens, out).reshape(background.shape)


def optimal_interpolation_ensi_multi_ebesc(bgrid, bratios, background,
                                           points, pobs, pratios,
                                           pbackground, structure,
                                           max_points,
                                           allow_extrapolation=True):
    """Member-by-member update with static correlations
    (oi_ensi_multi.cpp:629-860)."""
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background)
    bratios = asarray_f32(bratios, "bratios")
    pobs = asarray_f32(pobs, "pobs")
    pratios = asarray_f32(pratios, "pratios")
    pbackground = asarray_f32(pbackground, "pbackground")
    bpoints, flat_bg, is_grid = _flatten_grid(bgrid, background,
                                              "background")
    n, n_ens = flat_bg.shape
    flat_ratios = bratios.ravel()
    if flat_ratios.shape[0] != bpoints.size():
        raise ValueError("Bratios and grid size mismatch")
    _validate_multi(bpoints, points, n_ens, pobs, pratios, pbackground)
    if points.size() == 0 or n_ens == 0:
        return flat_bg.copy().reshape(background.shape)
    valid_ens = _valid_members(flat_bg, pbackground)
    if valid_ens.size == 0:
        return flat_bg.copy().reshape(background.shape)
    # Canonical-shortlist device route (see ebe above).
    if not host:
        out_sl = _member_shortlist(
            bpoints, points, structure, max_points, allow_extrapolation,
            _members(flat_bg, valid_ens), flat_ratios, pobs, pratios,
            pbackground, valid_ens, dev)
        if out_sl is not None:
            return _with_members(flat_bg, valid_ens, out_sl).reshape(
                background.shape)

    prep = _common_prep(bpoints, points, structure, max_points,
                        np.isfinite(pobs[:, 0]), dev)
    if prep is None:
        return flat_bg.copy().reshape(background.shape)
    keep, cand, mask, p1_all, o_fields, loc = prep
    innov = (pobs[:, valid_ens] - pbackground[:, valid_ens])[keep]

    kt = _native_ready(structure, host)
    if kt is not None:
        from .. import native
        gfx, ofx = _native_member_geom(bpoints, points, keep, structure,
                                       p1_all, o_fields, loc)
        out_nat = native.oi_member_host_solve(
            gfx, ofx, pratios[keep], innov.astype(np.float32), None, None,
            flat_ratios, cand, mask, kt, int(max_points),
            bool(allow_extrapolation), False, _members(flat_bg, valid_ens))
        if out_nat is not None:
            return _with_members(flat_bg, valid_ens, out_nat).reshape(
                background.shape)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    t_ratios, t_innov = t(pratios[keep]), t(innov.astype(np.float32))
    bg_t, br_t = t(_members(flat_bg, valid_ens)), t(flat_ratios)

    def kernel(p1, cf, cv, *args):
        return ebesc_kernel(structure, p1, cf, cv, *args, int(max_points),
                            bool(allow_extrapolation))

    def per_block(start, end, cand_t):
        return (bg_t[start:end], br_t[start:end], t_ratios[cand_t],
                t_innov[cand_t])

    out = _run_blocks(kernel, n, cand, mask, p1_all, o_fields, per_block,
                      len(valid_ens), dev)
    return _with_members(flat_bg, valid_ens, out).reshape(background.shape)


def optimal_interpolation_ensi_multi_utem(bgrid, bratios, background,
                                          background_corr, points, pobs,
                                          pratios, pbackground,
                                          pbackground_corr, structure,
                                          max_points,
                                          allow_extrapolation=True):
    """ETKF update with correlations from a second ensemble
    (oi_ensi_multi.cpp:862-1311)."""
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background)
    background_corr = asarray_f32(background_corr, "background_corr")
    bratios = asarray_f32(bratios, "bratios")
    pobs = asarray_f32(pobs, "pobs")
    pratios = asarray_f32(pratios, "pratios")
    pbackground = asarray_f32(pbackground, "pbackground")
    pbackground_corr = asarray_f32(pbackground_corr, "pbackground_corr")
    bpoints, flat_bg, is_grid = _flatten_grid(bgrid, background,
                                              "background")
    _, flat_bgc, _ = _flatten_grid(bgrid, background_corr,
                                   "background_corr")
    n, n_ens = flat_bg.shape
    if flat_bgc.shape != flat_bg.shape:
        raise ValueError("Input background_corr field is not the same "
                         "size as the grid")
    flat_ratios = bratios.ravel()
    if flat_ratios.shape[0] != bpoints.size():
        raise ValueError("Bratios and grid size mismatch")
    _validate_multi(bpoints, points, n_ens, pobs, pratios, pbackground,
                    [(pbackground_corr, "pbackground_corr")],
                    pobs_1d=True)
    if points.size() == 0 or n_ens == 0:
        return flat_bg.copy().reshape(background.shape)
    valid_ens = _valid_members(flat_bg, flat_bgc, pbackground,
                               pbackground_corr)
    if valid_ens.size == 0:
        return flat_bg.copy().reshape(background.shape)

    # Canonical-shortlist device route (see ebe above).
    if not host:
        res_sl = _utem_shortlist(
            bpoints, points, structure, max_points, allow_extrapolation,
            _members(flat_bg, valid_ens), _members(flat_bgc, valid_ens),
            flat_ratios, pobs, pratios, pbackground, pbackground_corr,
            valid_ens, dev)
        if res_sl is not None:
            out_v, n_cond = res_sl
            _warn_condition(n_cond)
            return _with_members(flat_bg, valid_ens, out_v).reshape(
                background.shape)

    pv = pbackground[:, valid_ens].astype(np.float64)
    y_hat = pv.mean(axis=1)
    y_anom = np.where(np.isfinite(y_hat)[:, None], pv - y_hat[:, None], 0)
    y_corr = _norm_anom(pbackground_corr, valid_ens)

    prep = _common_prep(bpoints, points, structure, max_points,
                        np.isfinite(pobs), dev)
    if prep is None:
        return flat_bg.copy().reshape(background.shape)
    keep, cand, mask, p1_all, o_fields, loc = prep

    kt = _native_ready(structure, host)
    if kt is not None:
        from .. import native
        gfx, ofx = _native_member_geom(bpoints, points, keep, structure,
                                       p1_all, o_fields, loc)
        res_nat = native.oi_utem_host_solve(
            gfx, ofx, pobs[keep], pratios[keep],
            y_hat[keep].astype(np.float32),
            y_anom[keep].astype(np.float32), y_corr[keep], flat_ratios,
            cand, mask, kt, int(max_points), bool(allow_extrapolation),
            DEFAULT_MIN_STD, _members(flat_bg, valid_ens),
            _members(flat_bgc, valid_ens))
        if res_nat is not None:
            out_v, cond_bad = res_nat
            _warn_condition(int(cond_bad.sum()))
            return _with_members(flat_bg, valid_ens, out_v).reshape(
                background.shape)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    t_obs, t_ratios = t(pobs[keep]), t(pratios[keep])
    t_yanom = t(y_anom[keep].astype(np.float32))
    t_ycorr, t_yhat = t(y_corr[keep]), t(y_hat[keep].astype(np.float32))
    bg_t = t(_members(flat_bg, valid_ens))
    bgc_t = t(_members(flat_bgc, valid_ens))
    br_t = t(flat_ratios)

    def kernel(p1, cf, cv, *args):
        return utem_kernel(structure, p1, cf, cv, *args, int(max_points),
                           bool(allow_extrapolation))

    def per_block(start, end, cand_t):
        return (bg_t[start:end], bgc_t[start:end], br_t[start:end],
                t_obs[cand_t], t_ratios[cand_t], t_yanom[cand_t],
                t_ycorr[cand_t], t_yhat[cand_t])

    out = _run_blocks(kernel, n, cand, mask, p1_all, o_fields, per_block,
                      len(valid_ens), dev)
    return _with_members(flat_bg, valid_ens, out).reshape(background.shape)
