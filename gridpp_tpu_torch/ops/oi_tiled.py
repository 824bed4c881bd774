"""Tile-union OI: the serving path's per-tile candidate paging.

Neighbouring gridpoints select nearly the same observations, so the union
of all shortlisted obs across a (th x tw) tile of gridpoints is small
(C ~ 64-256). At construction `build_tile_tables` (host, numpy; a copy of
gridpp_tpu's) builds per tile a table of those union indices and, per
gridpoint, each candidate's slot in its tile's table. Per cycle the obs
values are gathered once per table entry (T*C rows) and routed to each
gridpoint's candidates with index gathers (gridpp_tpu pages them with
one-hot matmuls, the TPU's way to gather).

The solve is split in two so that every serving path shares its pieces:
the weight functions (`build_static_weights`, `build_weights_dynamic`)
produce per-gridpoint gain rows, and `oi_tiled_apply_weights` turns gain
rows and innovations into the analysis. `oi_tiled_sweep`, the full
re-solve, is `build_weights_dynamic` followed by the same apply, so a cached
weights table applied to a cycle equals the re-solve bit for bit.
Reference semantics: oi.cpp:221-341.
"""
from __future__ import annotations

import numpy as np
import torch

from .oi import _apply_increment, _select_top, _solve_weights

__all__ = ["build_tile_tables", "TileGeometry", "tile_fields",
           "untile_fields", "build_static_weights", "build_weights_dynamic",
           "oi_tiled_apply_weights", "oi_tiled_sweep"]


class TileGeometry:
    """Static per-(grid, points, structure) tiling state (host-built)."""

    def __init__(self, yx, th, tw, k_cap, c_cap, tile_table, table_mask,
                 local_idx, rho, valid, tile_static):
        self.yx = yx                  # (Y, X) original grid shape
        self.th, self.tw = th, tw     # tile shape in gridpoints
        self.k_cap = k_cap
        self.c_cap = c_cap            # union-table width C
        self.tile_table = tile_table  # (T, C) int32 obs indices
        self.table_mask = table_mask  # (T, C) bool
        self.local_idx = local_idx    # (T, TB, K) int32 in [0, C)
        self.rho = rho                # (T, TB, K) f32
        self.valid = valid            # (T, TB, K) bool
        self.tile_static = tile_static  # (T, C, Fs) f32 static obs fields
        self.static_keys = None       # list of field names for Fs axis


def _tile_order(y, x, th, tw):
    """Row-major flat index -> (tile, within-tile) permutation arrays."""
    yp = -(-y // th) * th
    xp = -(-x // tw) * tw
    ty, tx = yp // th, xp // tw
    # flat padded index in tile-major order
    ii, jj = np.meshgrid(np.arange(yp), np.arange(xp), indexing="ij")
    tile = (ii // th) * tx + (jj // tw)
    within = (ii % th) * tw + (jj % tw)
    return yp, xp, ty, tx, tile, within


def build_tile_tables(sel, rho, valid, obs_fields_np, yx, th=32, tw=64,
                      c_round=128):
    """Build per-tile union tables from the global shortlist (host).

    sel/rho/valid: (N, K) from the geometric selection sweep, N = Y*X in
    row-major order. obs_fields_np: dict of (P,) numpy static obs fields.
    Returns a TileGeometry with everything device-ready (numpy).
    """
    y, x = yx
    n, k_cap = sel.shape
    sel = np.asarray(sel)
    rho = np.asarray(rho)
    valid = np.asarray(valid)
    yp, xp, ty, tx, tile, within = _tile_order(y, x, th, tw)
    t_count, tb = ty * tx, th * tw

    # scatter row-major (N, K) into (T, TB, K), padding with invalid
    sel_t = np.zeros((t_count, tb, k_cap), np.int64)
    rho_t = np.zeros((t_count, tb, k_cap), np.float32)
    val_t = np.zeros((t_count, tb, k_cap), bool)
    core = (slice(None, y), slice(None, x))
    tile_c, within_c = tile[core].ravel(), within[core].ravel()
    sel_t[tile_c, within_c] = sel.reshape(n, k_cap)
    rho_t[tile_c, within_c] = rho.reshape(n, k_cap)
    val_t[tile_c, within_c] = valid.reshape(n, k_cap)

    # per-tile unions
    uniques = []
    c_max = 1
    for t in range(t_count):
        u = np.unique(sel_t[t][val_t[t]])
        uniques.append(u)
        c_max = max(c_max, len(u))
    c_cap = -(-c_max // c_round) * c_round

    tile_table = np.zeros((t_count, c_cap), np.int32)
    table_mask = np.zeros((t_count, c_cap), bool)
    local_idx = np.zeros((t_count, tb, k_cap), np.int32)
    for t, u in enumerate(uniques):
        c = len(u)
        tile_table[t, :c] = u
        table_mask[t, :c] = True
        if c:
            li = np.searchsorted(u, sel_t[t].ravel())
            li = np.clip(li, 0, c - 1)
            ok = val_t[t].ravel() & (u[li] == sel_t[t].ravel())
            local_idx[t] = np.where(ok, li, 0).reshape(tb, k_cap)
            val_t[t] &= ok.reshape(tb, k_cap)
        else:
            val_t[t] = False

    keys = sorted(obs_fields_np)
    tile_static = np.stack(
        [np.asarray(obs_fields_np[key], np.float32)[tile_table]
         for key in keys], axis=-1)  # (T, C, Fs)
    tile_static[~table_mask] = 0.0

    geom = TileGeometry(yx, th, tw, k_cap, c_cap, tile_table, table_mask,
                        local_idx, rho_t, val_t, tile_static)
    geom.static_keys = keys
    geom.grid_pad = (yp, xp, ty, tx)
    return geom


def tile_fields(field, geom):
    """(Y, X) -> (T, TB) in tile-major order; padding cells are NaN."""
    y, x = geom.yx
    yp, xp, ty, tx = geom.grid_pad
    f = torch.full((yp, xp), torch.nan, dtype=field.dtype,
                   device=field.device)
    f[:y, :x] = field
    f = f.reshape(ty, geom.th, tx, geom.tw).permute(0, 2, 1, 3)
    return f.reshape(ty * tx, geom.th * geom.tw)


def untile_fields(tiled, geom):
    """(T, TB) -> (Y, X), the inverse of tile_fields."""
    y, x = geom.yx
    yp, xp, ty, tx = geom.grid_pad
    f = tiled.reshape(ty, tx, geom.th, geom.tw).permute(0, 2, 1, 3)
    return f.reshape(yp, xp)[:y, :x]


def _page(table, t0, idx):
    """Rows of a per-tile table for per-gridpoint slots.

    table: (T, C, F); idx: (nt, ...) int slots into C for tiles
    [t0, t0 + nt). Returns idx.shape + (F,)."""
    nt = idx.shape[0]
    c_cap, f = table.shape[1], table.shape[2]
    base = torch.arange(t0, t0 + nt, device=idx.device,
                        dtype=torch.int64) * c_cap
    flat = idx.reshape(nt, -1).long() + base[:, None]
    return table.reshape(-1, f).index_select(0, flat.reshape(-1)).reshape(
        idx.shape + (f,))


def _s_cap(max_points, k_cap):
    return min(max_points, k_cap) if max_points > 0 else k_cap


def _weights_out(t_count, tb, s_cap, device):
    return {"local_s": torch.empty((t_count, tb, s_cap), dtype=torch.int32,
                                   device=device),
            "valid_s": torch.empty((t_count, tb, s_cap), dtype=torch.bool,
                                   device=device),
            "weights": torch.empty((t_count, tb, s_cap),
                                   dtype=torch.float32, device=device),
            "a_scalar": torch.empty((t_count, tb), dtype=torch.float32,
                                    device=device)}


def build_static_weights(structure, geom_dev, static_keys, ratios,
                         max_points: int, tiles_per_step: int = 256):
    """Per-gridpoint OI gain rows for a static, all-valid obs network.

    With every obs valid and the ratios fixed, the selection is the first
    S shortlist entries and the whole solve x = (P + R)^-1 G
    (oi.cpp:289-315) is geometry: a cycle then costs one weighted sum.
    Returns {local_s, valid_s, weights, a_scalar}, each (T, TB, S) except
    a_scalar (T, TB).
    """
    local_idx = geom_dev["local_idx"]
    tile_table = geom_dev["tile_table"].long()
    t_count, tb, k_cap = local_idx.shape
    s_cap = _s_cap(max_points, k_cap)
    fs = geom_dev["tile_static"].shape[-1]
    table = torch.cat([geom_dev["tile_static"],
                       ratios[tile_table][:, :, None]], dim=-1)
    out = _weights_out(t_count, tb, s_cap, local_idx.device)
    out["local_s"].copy_(local_idx[:, :, :s_cap])
    out["valid_s"].copy_(geom_dev["valid"][:, :, :s_cap])
    for t0 in range(0, t_count, tiles_per_step):
        t1 = min(t0 + tiles_per_step, t_count)
        b = (t1 - t0) * tb
        fields = _page(table, t0, out["local_s"][t0:t1]).reshape(
            b, s_cap, fs + 1)
        sv = out["valid_s"][t0:t1].reshape(b, s_cap)
        lg = torch.where(sv, geom_dev["rho"][t0:t1, :, :s_cap].reshape(
            b, s_cap), 0.0)
        sel_fields = {key: fields[:, :, i]
                      for i, key in enumerate(static_keys)}
        x = _solve_weights(structure, sel_fields, lg, sv, fields[:, :, fs])
        out["weights"][t0:t1] = x.reshape(t1 - t0, tb, s_cap)
        out["a_scalar"][t0:t1] = torch.sum(x * lg, dim=-1).reshape(
            t1 - t0, tb)
    return out


def build_weights_dynamic(structure, geom_dev, static_keys, ratios,
                          obs_valid, max_points: int,
                          tiles_per_step: int = 256, out=None):
    """Per-gridpoint OI gain rows for this cycle's obs validity and ratios.

    The cycle's expensive half — masked top-S re-selection on the stored
    canonical rho, S x S assembly, solve — depends only on (obs validity,
    ratios), not on the obs values, so the serving path can cache its
    result across cycles (api/pipeline.py).

    ratios: (P,) f32; obs_valid: (P,) f32 0/1. Returns {local_s, valid_s,
    weights, a_scalar} as build_static_weights does: new tensors, or the
    caller's `out` (a dict holding those four, of their shapes and types;
    other keys are left alone), written in place with the same bits.
    """
    local_idx = geom_dev["local_idx"]
    tile_table = geom_dev["tile_table"].long()
    t_count, tb, k_cap = local_idx.shape
    s_cap = _s_cap(max_points, k_cap)
    fs = geom_dev["tile_static"].shape[-1]
    table = torch.cat([geom_dev["tile_static"],
                       torch.stack([ratios[tile_table],
                                    obs_valid[tile_table]], dim=-1)], dim=-1)
    if out is None:
        out = _weights_out(t_count, tb, s_cap, local_idx.device)
    for t0 in range(0, t_count, tiles_per_step):
        t1 = min(t0 + tiles_per_step, t_count)
        b = (t1 - t0) * tb
        li = local_idx[t0:t1].reshape(b, k_cap)
        fk = _page(table, t0, local_idx[t0:t1]).reshape(b, k_cap, fs + 2)
        va = geom_dev["valid"][t0:t1].reshape(b, k_cap) & (
            fk[:, :, fs + 1] > 0.5)
        vals, sub, sel_valid = _select_top(
            geom_dev["rho"][t0:t1].reshape(b, k_cap), va, s_cap)
        lg = torch.where(sel_valid, vals, 0.0)
        fields = torch.gather(fk, 1, sub[:, :, None].expand(-1, -1, fs + 2))
        sel_fields = {key: fields[:, :, i]
                      for i, key in enumerate(static_keys)}
        x = _solve_weights(structure, sel_fields, lg, sel_valid,
                           fields[:, :, fs])
        shape = (t1 - t0, tb, s_cap)
        out["local_s"][t0:t1] = torch.gather(li, 1, sub).reshape(shape)
        out["valid_s"][t0:t1] = sel_valid.reshape(shape)
        out["weights"][t0:t1] = x.reshape(shape)
        out["a_scalar"][t0:t1] = torch.sum(x * lg, dim=-1).reshape(
            t1 - t0, tb)
    return out


def oi_tiled_apply_weights(weights, tile_table, background_t, innov,
                           allow_extrapolation: bool,
                           tiles_per_step: int = 1024, out=None):
    """Apply gain rows: analysis = background + weights . innovations.

    weights: from build_static_weights / build_weights_dynamic. innov: (P,)
    obs minus background at the obs, 0 where invalid, this cycle.
    background_t: (T, TB). Returns (T, TB): a new tensor, or `out` (the
    serving graphs' static buffer) written in place with the same bits.
    """
    local_s = weights["local_s"]
    valid_s = weights["valid_s"]
    t_count, tb, s_cap = local_s.shape
    table = innov[tile_table.long()][:, :, None]  # (T, C, 1)
    if out is None:
        out = torch.empty_like(background_t)
    for t0 in range(0, t_count, tiles_per_step):
        t1 = min(t0 + tiles_per_step, t_count)
        b = (t1 - t0) * tb
        va = valid_s[t0:t1].reshape(b, s_cap)
        inn = torch.where(va, _page(table, t0, local_s[t0:t1]).reshape(
            b, s_cap), 0.0)
        out[t0:t1] = _apply_increment(
            weights["weights"][t0:t1].reshape(b, s_cap), inn, va,
            background_t[t0:t1].reshape(b),
            allow_extrapolation).reshape(t1 - t0, tb)
    return out


def oi_tiled_sweep(structure, geom_dev, static_keys, background_t,
                   bvariance_t, packed_dyn, max_points: int,
                   allow_extrapolation: bool, tiles_per_step: int = 256):
    """Whole-grid tiled OI, re-solved from scratch.

    geom_dev: dict of device tensors {tile_table, local_idx, rho, valid,
    tile_static}. background_t/bvariance_t: (T, TB). packed_dyn: (P, 4)
    columns [obs, obs_y, ratios, valid01], obs and obs_y 0 where invalid.
    Returns the (T, TB) analysis and analysis variance.
    """
    w = build_weights_dynamic(structure, geom_dev, static_keys,
                              packed_dyn[:, 2], packed_dyn[:, 3], max_points,
                              tiles_per_step)
    innov = packed_dyn[:, 0] - packed_dyn[:, 1]
    out = oi_tiled_apply_weights(w, geom_dev["tile_table"], background_t,
                                 innov, allow_extrapolation)
    ok = w["valid_s"].any(dim=-1) & torch.isfinite(background_t)
    avar = torch.where(ok, bvariance_t * (1 - w["a_scalar"]), bvariance_t)
    return out, avar
