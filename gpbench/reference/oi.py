"""Deterministic optimal interpolation (reference oi.cpp:221-341).

For each gridpoint, with its selected stations i = 1..S (the S highest rho
among the valid ones, geometry.py):
    A = [rho(o_i, o_j)] + diag(ratio_i)       (S x S, Barnes between obs)
    A x = [rho(g, o_i)]                       (the gain row x)
    analysis = background + sum_i x_i (obs_i - background at o_i)
where `background` is the smoothed field (stencil.py) and the background
at an obs is the smoothed field at the obs' nearest gridpoint. A gridpoint
with no valid station in range keeps its background. The solve is float64
(`torch.linalg.solve`), as gridpp's is in double.

`low=True` is the control: the increment in float32 with TF32 operands
(`tf32`: rho, the matrix, the ratios, the gain row and the innovations
rounded to TF32, the solve in float32 on the rounded inputs, the products
summed in float32), the step below the configuration's float32 with TF32
off.
"""
from __future__ import annotations

import torch

from . import geometry, tf32

ROWS_PER_BLOCK = 1 << 18


def _rounded(t, low: bool):
    return tf32(t) if low else t


def gains(sel, rho, sxyz, ratios, h: float, low: bool = False):
    """The gain row x (M, S) of each row, 0 in empty slots.

    sel: (M, S) station ids (-1: no station); rho: (M, S) rho of gridpoint
    to station; sxyz: (P, 3) float64 station coordinates; ratios: (P,)
    float64. low: the TF32 control (x then float32, TF32 values)."""
    loc = geometry.localization(h)
    m, s_cap = sel.shape
    out = torch.empty((m, s_cap), dtype=torch.float32 if low
                      else torch.float64, device=sel.device)
    eye = torch.eye(s_cap, dtype=torch.bool, device=sel.device)
    for a in range(0, m, ROWS_PER_BLOCK):
        s = sel[a:a + ROWS_PER_BLOCK]
        ok = s >= 0
        g = s.clamp(min=0)
        p = sxyz[g]
        d2 = ((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
        pair = ok[:, :, None] & ok[:, None, :]
        mat = _rounded(torch.where(pair, geometry.barnes(d2, h, loc), 0.0),
                       low)
        mat = mat + torch.where(ok, _rounded(ratios[g], low),
                                1.0)[:, :, None] * eye
        rhs = _rounded(torch.where(ok, rho[a:a + ROWS_PER_BLOCK], 0.0), low)
        x = torch.where(ok, torch.linalg.solve(mat, rhs), 0.0)
        out[a:a + ROWS_PER_BLOCK] = _rounded(x, low)
    return out


def analysis(flat, sel, x, innov, low: bool = False):
    """Analysis (M,) float64: flat (M,) smoothed background of the rows,
    their selections sel (M, S) and gain rows x (M, S); innov (P,) the
    innovation obs - smoothed background at the obs' nearest gridpoint,
    float64. A row with no station, or a non-finite background, keeps its
    background."""
    dv = torch.where(sel >= 0, innov[sel.clamp(min=0)], 0.0)
    inc = (x * _rounded(dv, low)).sum(-1)
    live = (sel >= 0).any(dim=1) & torch.isfinite(flat)
    return torch.where(live, flat + inc.to(torch.float64), flat)
