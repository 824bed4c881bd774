"""Optimal interpolation on tensors (gridpp_tpu/ops/oi.py, oi.cpp:221-341).

Per gridpoint: keep the top max_points candidates by rho among the valid
ones, assemble the S x S local covariance plus the ratio ridge, solve it,
and add the weighted innovations to the background. Rows are batch-first,
(B, S) and (B, S, S); the arithmetic and its order follow gridpp_tpu's
batch-last TPU layout element for element.

Three ways to select, as in gridpp_tpu: `oi_block`/`oi_gather_block`
evaluate the structure against host-fed candidate lists,
`oi_block_dense`/`oi_dense_sweep` against every observation (rho > 0 is
the radius query: every structure zeroes rho beyond its localization
distance), and `oi_block_from_candidates`/`oi_shortlist_sweep` re-select
from the canonical shortlist's stored rho (ops/canonical.py). The sweeps
are Python loops over row blocks, plain functions on tensors.
"""
from __future__ import annotations

import torch

__all__ = ["oi_block", "oi_block_dense", "oi_gather_block",
           "oi_block_from_candidates", "oi_dense_sweep",
           "oi_shortlist_sweep", "shortlist_starved"]

# Rows at most this wide are ranked by one stable sort; wider rows (the
# dense path's rows hold every observation) by a top-k on a unique key
_SORT_WIDTH = 128


def _blocks(n: int, block: int):
    """Row slices of at most `block` rows covering range(n)."""
    if block < 1:
        raise ValueError("block must be >= 1")
    return [slice(i, min(i + block, n)) for i in range(0, n, block)]


def _top_index(neg, s_cap: int):
    """Positions of the s_cap largest values of each row of neg (B, K) f32,
    largest first and the lower position first among equal values.

    One torch.topk on a unique int64 key: the value's f32 bits made
    order-preserving as a signed integer, above the reversed position.
    Equal to a stable descending sort's first s_cap columns, without
    sorting the whole row."""
    k = neg.shape[-1]
    bits = neg.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key.bitwise_left_shift_(32)
    key.bitwise_or_(torch.arange(k - 1, -1, -1, device=neg.device))
    return torch.topk(key, s_cap, dim=-1, sorted=True).indices


def _select_top(rho, valid, s_cap: int):
    """Top-s_cap candidates by rho among valid ones (oi.cpp:262-281).

    The lower slot wins a tie, as jax.lax.top_k does (torch.topk on the
    values promises no order among ties): a stable descending sort for
    narrow rows, `_top_index` for wide ones."""
    neg = torch.where(valid, rho, -torch.inf)
    if neg.shape[-1] <= _SORT_WIDTH:
        vals, sel = torch.sort(neg, dim=-1, descending=True, stable=True)
        vals, sel = vals[:, :s_cap], sel[:, :s_cap]
    else:
        sel = _top_index(neg, s_cap)
        vals = torch.gather(neg, 1, sel)
    return vals, sel, torch.isfinite(vals)


def _gj_solve(a, b):
    """Solve a[i] @ x[i] = b[i] for every batch row i.

    a: (B, S, S), b: (B, S). Unrolled Gauss-Jordan without pivoting, in
    f32 — valid because the OI system is a correlation matrix plus a
    positive diagonal ridge (SPD), and masked-out rows are identity rows.
    Same elimination order as gridpp_tpu's _gj_solve_batch_last.
    """
    s = a.shape[1]
    m = torch.cat([a, b[:, :, None]], dim=2)  # (B, S, S+1)
    for k in range(s):
        row = m[:, k, :] / m[:, k, k:k + 1]  # (B, S+1)
        m = m - m[:, :, k:k + 1] * row[:, None, :]
        m[:, k, :] = row
    return m[:, :, s]


def _solve_weights(structure, sel_fields, lg, sel_valid, l_r):
    """Gain rows x (B, S) of the selected candidates (oi.cpp:289-315).

    sel_fields: dict of (B, S) static obs fields; lg: (B, S) selected rho
    (0 where invalid); sel_valid: (B, S) bool; l_r: (B, S) ratios.
    """
    s_cap = lg.shape[1]
    pi = {key: v[:, :, None] for key, v in sel_fields.items()}
    pj = {key: v[:, None, :] for key, v in sel_fields.items()}
    lp = torch.as_tensor(structure.corr_torch(pi, pj), dtype=torch.float32,
                         device=lg.device)
    pair_valid = sel_valid[:, :, None] & sel_valid[:, None, :]
    eye = torch.eye(s_cap, dtype=torch.float32, device=lg.device)[None]
    ridge = torch.where(sel_valid, l_r, 1.0)[:, None, :] * eye
    a_mat = torch.where(pair_valid, lp, 0.0) + ridge
    a_mat = torch.where(pair_valid | (eye > 0), a_mat, 0.0)
    x = _gj_solve(a_mat, lg.to(torch.float32))
    return torch.where(sel_valid, x, 0.0)


def _apply_increment(x, innov, sel_valid, background, allow_extrapolation):
    """background + x . innov per row, with the reference's
    no-extrapolation clamp (oi.cpp:317-341) when it is off.

    x, innov: (B, S), innov 0 where not sel_valid; background: (B,)."""
    increment = torch.sum(x * innov, dim=-1)
    if not allow_extrapolation:
        max_inc = torch.amax(torch.where(sel_valid, innov, -torch.inf),
                             dim=-1)
        min_inc = torch.amin(torch.where(sel_valid, innov, torch.inf),
                             dim=-1)
        c1 = (max_inc > 0) & (increment > max_inc)
        c2 = ~c1 & (max_inc < 0) & (increment > 0)
        c3 = ~c1 & ~c2 & (min_inc < 0) & (increment < min_inc)
        c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (increment < 0)
        increment = torch.where(c1 | c2, max_inc,
                                torch.where(c3 | c4, min_inc, increment))
    ok = sel_valid.any(dim=-1) & torch.isfinite(background)
    return torch.where(ok, background + increment, background)


def _solve_selected(structure, sel_fields, lg, sel_valid, l_obs, l_y, l_r,
                    background, bvariance, allow_extrapolation: bool):
    """Shared OI tail: S x S assembly, solve, clamp (oi.cpp:289-341).
    Returns (analysis (B,), analysis variance (B,))."""
    x = _solve_weights(structure, sel_fields, lg, sel_valid, l_r)
    innov = torch.where(sel_valid, l_obs - l_y, 0.0)
    out = _apply_increment(x, innov, sel_valid, background,
                           allow_extrapolation)
    a_scalar = torch.sum(x * lg, dim=-1)
    ok = sel_valid.any(dim=-1) & torch.isfinite(background)
    avar = torch.where(ok, bvariance * (1 - a_scalar), bvariance)
    return out, avar


def oi_block_from_candidates(structure, cand_sel, cand_rho, cand_valid,
                             obs_fields, background, bvariance, obs, obs_y,
                             ratios, max_points: int,
                             allow_extrapolation: bool):
    """OI with a precomputed geometric candidate shortlist.

    cand_sel/cand_rho/cand_valid: (B, K); obs_fields: dict of (P,) static
    obs fields; background/bvariance: (B,); obs/obs_y/ratios: (P,).
    Candidates whose obs or background-at-obs is missing this cycle are
    masked and the top max_points re-selected among the survivors.
    """
    k = cand_sel.shape[1]
    s_cap = min(max_points, k) if max_points > 0 else k
    sel = cand_sel.long()
    valid = (cand_valid & torch.isfinite(obs[sel])
             & torch.isfinite(obs_y[sel]))
    vals, sub, sel_valid = _select_top(cand_rho, valid, s_cap)
    lg = torch.where(sel_valid, vals, 0.0)
    g = torch.gather(sel, 1, sub)
    sel_fields = {key: v[g] for key, v in obs_fields.items()}
    return _solve_selected(structure, sel_fields, lg, sel_valid, obs[g],
                           obs_y[g], ratios[g], background, bvariance,
                           allow_extrapolation)


def oi_block(structure, p1_fields, cand_fields, cand_rho_valid, background,
             bvariance, obs, obs_y, ratios, max_points: int,
             allow_extrapolation: bool):
    """OI for a block of gridpoints with host-fed candidates.

    p1_fields: dict of (B, 1) gridpoint fields; cand_fields: dict of (B, K)
    candidate obs fields; cand_rho_valid: (B, K) candidates in range with
    valid obs; obs/obs_y/ratios: (B, K) gathered; background/bvariance:
    (B,). Returns (analysis (B,), analysis variance (B,))."""
    k = obs.shape[1]
    s_cap = min(max_points, k) if max_points > 0 else k
    rho = structure.corr_background_torch(p1_fields, cand_fields)
    vals, sel, sel_valid = _select_top(rho, cand_rho_valid & (rho > 0),
                                       s_cap)
    lg = torch.where(sel_valid, vals, 0.0).to(torch.float32)
    sel_fields = {key: torch.gather(v, 1, sel)
                  for key, v in cand_fields.items()}
    return _solve_selected(structure, sel_fields, lg, sel_valid,
                           torch.gather(obs, 1, sel),
                           torch.gather(obs_y, 1, sel),
                           torch.gather(ratios, 1, sel), background,
                           bvariance, allow_extrapolation)


def oi_gather_block(structure, p1_fields, obs_fields, cand, mask,
                    background, bvariance, obs, obs_y, ratios,
                    max_points: int, allow_extrapolation: bool):
    """`oi_block` from candidate lists: cand (B, K) obs indices and mask
    (B, K); obs_fields: dict of (P,); obs/obs_y/ratios: (P,)."""
    cand = cand.long()
    return oi_block(structure, p1_fields,
                    {key: v[cand] for key, v in obs_fields.items()}, mask,
                    background, bvariance, obs[cand], obs_y[cand],
                    ratios[cand], max_points, allow_extrapolation)


def oi_block_dense(structure, p1_fields, obs_fields, background, bvariance,
                   obs, obs_y, ratios, max_points: int,
                   allow_extrapolation: bool):
    """OI with rho against every observation, then the top max_points.

    p1_fields: dict of (B, 1); obs_fields: dict of (P,); obs/obs_y/ratios:
    (P,)."""
    p = obs.shape[0]
    s_cap = min(max_points, p) if max_points > 0 else p
    o2 = {key: v[None, :] for key, v in obs_fields.items()}
    rho = structure.corr_background_torch(p1_fields, o2)  # (B, P)
    vals, sel, sel_valid = _select_top(rho, rho > 0, s_cap)
    lg = torch.where(sel_valid, vals, 0.0).to(torch.float32)
    sel_fields = {key: v[sel] for key, v in obs_fields.items()}
    return _solve_selected(structure, sel_fields, lg, sel_valid, obs[sel],
                           obs_y[sel], ratios[sel], background, bvariance,
                           allow_extrapolation)


def oi_dense_sweep(structure, p1_fields, obs_fields, background, bvariance,
                   obs, obs_y, ratios, max_points: int,
                   allow_extrapolation: bool, block: int):
    """Whole-grid `oi_block_dense`, `block` rows at a time, so the (B, P)
    rho matrix stays bounded. p1_fields: dict of (N,); background and
    bvariance: (N,). Returns (analysis (N,), analysis variance (N,))."""
    out = torch.empty_like(background)
    avar = torch.empty_like(bvariance)
    for rows in _blocks(background.shape[0], block):
        out[rows], avar[rows] = oi_block_dense(
            structure, {key: v[rows, None] for key, v in p1_fields.items()},
            obs_fields, background[rows], bvariance[rows], obs, obs_y,
            ratios, max_points, allow_extrapolation)
    return out, avar


def shortlist_starved(sel, valid, truncated, obs_ok, s_cap: int):
    """Rows whose shortlist was truncated (more in-range candidates exist
    beyond its K) and that keep fewer than s_cap valid candidates under
    this cycle's obs validity: the reference digs deeper there
    (oi.cpp:250-281), so callers must fall back to a full-depth path.

    sel/valid: (N, K); truncated: (N,); obs_ok: (P,) bool. Returns the
    count, a device scalar."""
    cnt = (valid & obs_ok[sel.long()]).sum(dim=1)
    return (truncated & (cnt < s_cap)).sum()


def oi_shortlist_sweep(structure, sel, rho, valid, truncated, obs_fields,
                       background, bvariance, obs, obs_y, ratios,
                       max_points: int, allow_extrapolation: bool,
                       block: int):
    """Whole-grid OI from a canonical shortlist (gridpp_tpu
    make_oi_shortlist_sweep): `oi_block_from_candidates`, `block` rows at
    a time.

    sel/rho/valid: (N, K); truncated: (N,); obs_fields: dict of (P,);
    background/bvariance: (N,); obs/obs_y/ratios: (P,). Returns (analysis
    (N,), analysis variance (N,), the number of starved rows as a device
    scalar; see `shortlist_starved`)."""
    k = sel.shape[1]
    s_cap = min(max_points, k) if max_points > 0 else k
    out = torch.empty_like(background)
    avar = torch.empty_like(bvariance)
    for rows in _blocks(background.shape[0], block):
        out[rows], avar[rows] = oi_block_from_candidates(
            structure, sel[rows], rho[rows], valid[rows], obs_fields,
            background[rows], bvariance[rows], obs, obs_y, ratios,
            max_points, allow_extrapolation)
    starved = shortlist_starved(sel, valid, truncated,
                                torch.isfinite(obs) & torch.isfinite(obs_y),
                                s_cap)
    return out, avar, starved
