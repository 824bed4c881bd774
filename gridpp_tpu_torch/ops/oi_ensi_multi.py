"""Multi-variant ensemble OI on tensors (gridpp_tpu/ops/oi_ensi_multi.py,
reference src/api/oi_ensi_multi.cpp).

Three schemes, each batched over blocks of gridpoints, rows batch-first:
- ebe  ("ensemble member by ensemble member", oi_ensi_multi.cpp:329-627):
  per-member innovations; correlations from a second `background_corr`
  ensemble via Schur products of localization with normalized-anomaly
  outer products; gain lK = lr_lr inv(lR_rr + R_dd).
- ebesc (static correlations, 629-860): same innovation structure, but
  correlations purely from the structure function.
- utem ("use the ensemble mean", 862-1311): ETKF-style transform like
  EnSI but with correlation anomalies from `background_corr` and the
  W/w combination scaled by the ensemble std and bratios.

Padded slots use the Rinv=0 / innov=0 trick throughout. Standard
deviations are population ones (correction=0), as jnp.std's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tracing import count, span
from .oi import _blocks, _gj_solve, _select_top
from .oi_ensi import _finish, _mm, _mv, _reselect, _s_cap, _transform

__all__ = ["DEFAULT_MIN_STD", "norm_anom", "ebe_kernel", "ebesc_kernel",
           "utem_kernel", "member_table", "utem_table", "member_serve_sweep",
           "utem_serve_sweep"]

DEFAULT_MIN_STD = 0.0013


def norm_anom(arr):
    """Normalized anomalies (oi_ensi_multi.cpp:421-445): 1/sqrt(E-1)
    (v-mean)/std, zeroed for tiny/invalid std. arr: (N, E) all members
    valid."""
    e = arr.shape[1]
    mean = torch.mean(arr, dim=1)
    std = torch.std(arr, dim=1, correction=0)
    bad = ~torch.isfinite(mean) | ~torch.isfinite(std) \
        | (std <= DEFAULT_MIN_STD)
    denom = torch.where(std == 0, 1.0, std)
    out = (arr - mean[:, None]) / denom[:, None] / np.sqrt(max(e - 1, 1))
    return torch.where(bad[:, None], 0.0, out).to(torch.float32)


def _select(structure, p1_fields, cand_fields, cand_valid, max_points, k):
    """Top max_points candidates by rho among the valid ones. Returns
    (sel (B, S), sel_valid (B, S), l_rho (B, S))."""
    rho = structure.corr_background_torch(p1_fields, cand_fields)
    vals, sel, sel_valid = _select_top(rho, cand_valid & (rho > 0),
                                       _s_cap(max_points, k))
    return sel, sel_valid, torch.where(sel_valid, vals, 0.0).to(
        torch.float32)


def _pair_corr(structure, sel_fields):
    """(B, S, S) structure correlation between the selected obs, on their
    device (not torch's default one)."""
    pi = {key: v[:, :, None] for key, v in sel_fields.items()}
    pj = {key: v[:, None, :] for key, v in sel_fields.items()}
    return torch.as_tensor(structure.corr_torch(pi, pj),
                           dtype=torch.float32,
                           device=next(iter(sel_fields.values())).device)


def _anti_extrap_member(dx, innov, sel_valid):
    """Member-wise clamp (oi_ensi_multi.cpp:583-607): dx (B, E), innov
    (B, S, E)."""
    masked = torch.where(sel_valid[:, :, None], innov, torch.nan)
    max_inc = torch.amax(torch.where(torch.isnan(masked), -torch.inf,
                                     masked), dim=1)
    min_inc = torch.amin(torch.where(torch.isnan(masked), torch.inf,
                                     masked), dim=1)
    c1 = (max_inc > 0) & (dx > max_inc)
    c2 = ~c1 & (max_inc < 0) & (dx > 0)
    c3 = ~c1 & ~c2 & (min_inc < 0) & (dx < min_inc)
    c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (dx < 0)
    return torch.where(c1, max_inc,
                       torch.where(c2, 0.0,
                                   torch.where(c3, min_inc,
                                               torch.where(c4, 0.0, dx))))


def _member_update(structure, sel_fields, sel_valid, l_rho, l_r, l_innov,
                   background, bratios, allow_extrapolation: bool,
                   l_z=None, x_l=None):
    """Shared ebe/ebesc tail.

    sel_fields: dict (B, S); sel_valid/l_rho/l_r: (B, S); l_innov:
    (B, S, E) member innovations (masked rows zeroed); background: (B, E);
    bratios: (B,). ebe passes l_z (B, S, E) normalized obs anomalies and
    x_l (B, E) normalized gridpoint anomalies: pair corr = localization o
    (z z^T) and the numerator row = rho o (x_l . z^T)
    (oi_ensi_multi.cpp:524-579); ebesc (629-860) uses the structure
    correlations directly. The S x S solve is ops/oi._gj_solve, the
    elimination order of gridpp_tpu's _gj_solve_batch_last."""
    s_cap = l_rho.shape[1]
    loc = _pair_corr(structure, sel_fields)  # (B, S, S)
    if l_z is None:
        num = torch.where(sel_valid, l_rho, 0.0)
        pair = loc
    else:
        num = torch.where(sel_valid,
                          l_rho * (l_z * x_l[:, None, :]).sum(dim=2), 0.0)
        pair = loc * _mm(l_z, l_z.transpose(1, 2))
    pair_valid = sel_valid[:, :, None] & sel_valid[:, None, :]
    eye = torch.eye(s_cap, dtype=torch.float32, device=l_rho.device)
    ridge = torch.where(sel_valid, l_r, 1.0)[:, None, :] * eye
    a_mat = torch.where(pair_valid, pair, 0.0) + ridge
    a_mat = torch.where(pair_valid | (eye > 0), a_mat, 0.0)
    lk = _gj_solve(a_mat, num.to(torch.float32))  # (B, S)

    dx = bratios[:, None] * (lk[:, :, None] * l_innov).sum(dim=1)  # (B, E)
    if not allow_extrapolation:
        dx = _anti_extrap_member(dx, l_innov, sel_valid)
    ok = sel_valid.any(dim=1) & torch.isfinite(dx).all(dim=1)
    return torch.where(ok[:, None], background + dx, background)


def _utem_core(sel_valid, l_rho, l_obs, l_r, l_yhat, l_y, l_yc,
               background, background_corr, bratios,
               allow_extrapolation: bool):
    """ETKF update tail (oi_ensi_multi.cpp:862-1311), shared by the host
    kernel and the serving sweep. All inputs are post-selection:
    sel_valid/l_rho/l_obs/l_r/l_yhat: (B, S); l_y/l_yc: (B, S, E);
    background/background_corr: (B, E); bratios: (B,). Returns
    (analysis (B, E), cond_bad (B,))."""
    e = background.shape[1]
    rinv = torch.where(sel_valid, l_rho / l_r, 0.0)
    innov = torch.where(sel_valid, l_obs - l_yhat, 0.0)
    # Pinv = Yc^T Rinv Yc + I: SPD with lambda_min >= 1 by construction, so
    # the reference's `rcond <= 0` guard (oi_ensi_multi.cpp:1106-1121) can
    # only trigger on non-finite input (see ops/oi_ensi._transform)
    z, c_norm, w_vec, cond_ok = _transform(l_yc, rinv, innov, 1.0)

    ens_mean = torch.mean(background, dim=1)
    x = background - ens_mean[:, None]
    ens_std = torch.std(background, dim=1, correction=0)
    mean_corr = torch.mean(background_corr, dim=1)
    std_corr = torch.std(background_corr, dim=1, correction=0)
    const_fact = 1.0 / np.sqrt(max(e - 1, 1))
    x_corr = torch.where(std_corr[:, None] <= DEFAULT_MIN_STD, 0.0,
                         const_fact * (background_corr - mean_corr[:, None])
                         / torch.where(std_corr[:, None] == 0, 1.0,
                                       std_corr[:, None]))
    # increment_e = sum_k x_corr_k (ensStd W + bratios w 1^T)(k,e)
    # (oi_ensi_multi.cpp:1199-1204) with W = sqrt((E-1)/c) z symmetric -
    # computed as matvecs, W never materialized.
    increment = ens_std[:, None] \
        * torch.sqrt((e - 1) / c_norm)[:, None] * _mv(z, x_corr) \
        + bratios[:, None] * torch.sum(x_corr * w_vec, dim=1, keepdim=True)
    return _finish(increment, x, ens_mean, background, sel_valid, l_obs,
                   l_yhat, l_y, cond_ok, allow_extrapolation)


def _take(v, sel):
    """Gather (B, K) or (B, K, E) candidate values at sel (B, S)."""
    if v.dim() == 2:
        return torch.gather(v, 1, sel)
    return torch.take_along_dim(v, sel[:, :, None], dim=1)


def ebe_kernel(structure, p1_fields, cand_fields, cand_valid, background,
               bratios, x_l, pratios, innov, z_r, max_points: int,
               allow_extrapolation: bool):
    """ebe from host-fed candidates (gridpp_tpu make_ebe_kernel).

    p1_fields: dict of (B, 1); cand_fields: dict of (B, K); background:
    (B, E); x_l: (B, E) normalized gridpoint anomalies; pratios: (B, K);
    innov/z_r: (B, K, E)."""
    sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                    cand_valid, max_points, pratios.shape[1])
    l_innov = torch.where(sel_valid[:, :, None], _take(innov, sel), 0.0)
    return _member_update(
        structure, {key: _take(v, sel) for key, v in cand_fields.items()},
        sel_valid, l_rho, _take(pratios, sel), l_innov, background, bratios,
        allow_extrapolation, l_z=_take(z_r, sel), x_l=x_l)


def ebesc_kernel(structure, p1_fields, cand_fields, cand_valid, background,
                 bratios, pratios, innov, max_points: int,
                 allow_extrapolation: bool):
    """ebesc from host-fed candidates (gridpp_tpu make_ebesc_kernel)."""
    sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                    cand_valid, max_points, pratios.shape[1])
    l_innov = torch.where(sel_valid[:, :, None], _take(innov, sel), 0.0)
    return _member_update(
        structure, {key: _take(v, sel) for key, v in cand_fields.items()},
        sel_valid, l_rho, _take(pratios, sel), l_innov, background, bratios,
        allow_extrapolation)


def utem_kernel(structure, p1_fields, cand_fields, cand_valid, background,
                background_corr, bratios, obs, pratios, y_anom, y_corr,
                y_hat, max_points: int, allow_extrapolation: bool):
    """utem from host-fed candidates (gridpp_tpu make_utem_kernel).

    background/background_corr: (B, E); obs/pratios/y_hat: (B, K);
    y_anom/y_corr: (B, K, E). Returns (analysis, cond_bad)."""
    sel, sel_valid, l_rho = _select(structure, p1_fields, cand_fields,
                                    cand_valid, max_points, pratios.shape[1])
    return _utem_core(sel_valid, l_rho, _take(obs, sel), _take(pratios, sel),
                      _take(y_hat, sel), _take(y_anom, sel),
                      _take(y_corr, sel), background, background_corr,
                      bratios, allow_extrapolation)


def member_table(obs_fields, pratios, innov, pback_corr=None):
    """The packed per-obs table of `member_serve_sweep`: obs_fields (P, F)
    static obs fields, pratios (P,), innov (P, E) member innovations, and
    for ebe the normalized anomalies of pback_corr (P, E), the correlation
    ensemble at the obs."""
    cols = [obs_fields, pratios[:, None], innov]
    if pback_corr is not None:
        cols.append(norm_anom(pback_corr))
    return torch.cat(cols, dim=1)


def utem_table(pobs, pratios, pback, pback_corr):
    """The packed per-obs table of `utem_serve_sweep` from pobs/pratios
    (P,) and the two ensembles at the obs, pback/pback_corr (P, E): [obs,
    pratios, y_hat, y_anom(E), y_corr(E)]."""
    y_hat = pback.mean(dim=1)
    y_anom = torch.where(torch.isfinite(y_hat)[:, None],
                         pback - y_hat[:, None], 0.0)
    return torch.cat([pobs[:, None], pratios[:, None], y_hat[:, None],
                      y_anom, norm_anom(pback_corr)], dim=1)


def member_serve_sweep(structure, field_keys, background, bratios, x_l, tab,
                       obs_ok, cand, s_cap: int, block: int,
                       allow_extrapolation: bool):
    """Whole-grid ebe/ebesc cycle from a cached shortlist (gridpp_tpu
    make_member_serve_sweep).

    cand: (sel, rho, valid), each (N, K); a cycle re-masks them with this
    cycle's obs validity obs_ok (P,), re-selects the top s_cap, gathers ONE
    packed per-obs table row per selection and runs the member update.
    tab columns: [field_keys..., pratios, innov(E) {, z(E) for ebe}].
    x_l: (N, E) normalized gridpoint anomalies for ebe, None for ebesc.
    background: (N, E); bratios: (N,). Returns (N, E)."""
    sel, rho, valid = cand
    n, e = background.shape
    f = len(field_keys)
    out = torch.empty_like(background)
    for rows in _blocks(n, block):
        sel_valid, l_rho, g = _reselect(sel[rows], rho[rows], valid[rows],
                                        obs_ok, s_cap)
        ftab = tab[g]  # (B, S, W)
        l_innov = torch.where(sel_valid[:, :, None],
                              ftab[:, :, f + 1:f + 1 + e], 0.0)
        out[rows] = _member_update(
            structure, {key: ftab[:, :, i] for i, key in enumerate(
                field_keys)}, sel_valid, l_rho, ftab[:, :, f], l_innov,
            background[rows], bratios[rows], allow_extrapolation,
            l_z=None if x_l is None else ftab[:, :, f + 1 + e:f + 1 + 2 * e],
            x_l=None if x_l is None else x_l[rows])
    return out


def utem_serve_sweep(background, background_corr, bratios, tab, obs_ok,
                     cand, s_cap: int, block: int,
                     allow_extrapolation: bool):
    """Whole-grid utem cycle from a cached shortlist (gridpp_tpu
    make_utem_serve_sweep). The packed per-obs table is [obs, pratios,
    y_hat, y_anom(E), y_corr(E)]. Returns (analysis (N, E),
    n_condition_failures, a device scalar). Traced (tracing.py): each
    block counts `sweep.blocks`, its re-selection is the span
    `gridpp.cycle.select` and its table gather and update
    `gridpp.cycle.update`."""
    sel, rho, valid = cand
    n, e = background.shape
    out = torch.empty_like(background)
    cond_bad = torch.empty(n, dtype=torch.bool, device=background.device)
    for rows in _blocks(n, block):
        count("sweep.blocks")
        with span("gridpp.cycle.select"):
            sel_valid, l_rho, g = _reselect(sel[rows], rho[rows],
                                            valid[rows], obs_ok, s_cap)
        with span("gridpp.cycle.update"):
            ftab = tab[g]  # (B, S, W)
            out[rows], cond_bad[rows] = _utem_core(
                sel_valid, l_rho, ftab[:, :, 0], ftab[:, :, 1],
                ftab[:, :, 2], ftab[:, :, 3:3 + e],
                ftab[:, :, 3 + e:3 + 2 * e], background[rows],
                background_corr[rows], bratios[rows], allow_extrapolation)
    return out, cond_bad.sum()
