"""Optimal interpolation on tensors (gridpp_tpu/ops/oi.py, oi.cpp:221-341).

Per gridpoint: keep the top max_points candidates by stored rho among the
valid ones, assemble the S x S local covariance plus the ratio ridge,
solve it, and add the weighted innovations to the background. Rows are
batch-first, (B, S) and (B, S, S); the arithmetic and its order follow
gridpp_tpu's batch-last TPU layout element for element.
"""
from __future__ import annotations

import torch

__all__ = ["oi_block_from_candidates"]


def _select_top(rho, valid, s_cap: int):
    """Top-s_cap candidates by rho among valid ones (oi.cpp:262-281).

    A stable descending sort, so the lower slot wins a tie, as
    jax.lax.top_k does; torch.topk promises no order among ties."""
    neg = torch.where(valid, rho, -torch.inf)
    vals, sel = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, sel = vals[:, :s_cap], sel[:, :s_cap]
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
