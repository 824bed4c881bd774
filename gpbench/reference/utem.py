"""Ensemble OI, utem ("use the ensemble mean"): gridpp's
optimal_interpolation_ensi_multi_utem (reference oi_ensi_multi.cpp:
862-1311), an ETKF update whose correlations come from a second ensemble,
background_corr.

At each obs o: y_hat(o), the background members' mean at the obs' nearest
gridpoint, and Zc(o, e), the normalised anomalies of background_corr there,
(v - mean) / std / sqrt(E - 1) with the population std, 0 where the std is
at most MIN_STD (gridpp's DEFAULT_MIN_STD). For each gridpoint g, with its
selected stations i = 1..S (the S highest rho among the valid ones) and E
members:
    r_i   = rho(g, o_i) / pratio_i
    d_i   = obs_i - y_hat_i
    Pinv  = Zc^T diag(r) Zc + I                  (E x E)
    W     = sqrt(E - 1) Pinv^(-1/2)              (symmetric)
    w     = Pinv^-1 Zc^T diag(r) d
    xc    = background_corr's normalised anomaly at g (as Zc's rows)
    sigma = the background members' population std at g
    analysis_e = mean + sigma (W^T xc)_e + bratio_g (xc . w)
A gridpoint with no valid station in range keeps its members. Float64 with
Pinv^(-1/2) and Pinv^-1 from `torch.linalg.eigh`, as gridpp's armadillo
solve is in double.

Departures from the port's double-precision copy of gridpp's loop
(csrc/gridpp_kernels.cpp, oi_utem_host_solve), none of which changes the
analysis beyond float64 rounding:
- eigh is LAPACK's or cuSOLVER's, not a Jacobi sweep; it reads Pinv's lower
  triangle, where the copy averages Pinv with its transpose first;
- y_hat and Zc stay in float64, where the copy takes them as float32;
- the selection ranks by float64 rho, a near tie judged by the comparison
  (gpbench/harness/compare.py);
- no clamp: allow_extrapolation must be true (the configuration's);
- no condition count: Pinv >= I is never singular for finite input.

`low=True` is the control: the same in float32 with every matrix product
in TF32, the step below the configuration's float32 with TF32 off: each
product's operands are rounded to TF32 (`tf32`) and the product is summed
in float32.
"""
from __future__ import annotations

import math

import torch

from . import tf32
from .ensi import _eigh, obs_anomalies

ROWS_PER_BLOCK = 1 << 17
MIN_STD = 0.0013    # gridpp.h DEFAULT_MIN_STD


def norm_anom(x):
    """Normalised anomalies (M, E) float64 of the members x (M, E): 0 on a
    row whose population std is at most MIN_STD or not finite."""
    x = x.to(torch.float64)
    e = x.shape[1]
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, correction=0, keepdim=True)
    out = (x - mean) / torch.where(std == 0, 1.0, std) / math.sqrt(
        max(e - 1, 1))
    return torch.where(torch.isfinite(std) & (std > MIN_STD), out, 0.0)


def obs_terms(pback, pback_corr):
    """(y_hat (P,), Zc (P, E)) from the background and background_corr at
    the obs, each (P, E)."""
    return (obs_anomalies(pback.to(torch.float64))[0],
            norm_anom(pback_corr))


def _mm(u, v, low: bool):
    return torch.matmul(tf32(u), tf32(v)) if low else torch.matmul(u, v)


def analysis(members, members_corr, sel, rho, pobs, pratios, y_hat, zc,
             bratios, low: bool = False):
    """Analysis (M, E) float64 of the rows of members (M, E), with
    background_corr's members_corr (M, E), bratios (M,) and their
    selections sel/rho (M, S) (-1: no station). pobs, pratios, y_hat:
    (P,); zc: (P, E). low: the TF32 control."""
    dt = torch.float32 if low else torch.float64
    m, e = members.shape
    out = torch.empty((m, e), dtype=torch.float64, device=members.device)
    eye = torch.eye(e, dtype=dt, device=members.device)
    for a in range(0, m, ROWS_PER_BLOCK):
        rows = slice(a, a + ROWS_PER_BLOCK)
        s = sel[rows]
        ok = s >= 0
        g = s.clamp(min=0)
        r = torch.where(ok, rho[rows].to(dt) / pratios[g].to(dt), 0.0)
        d = torch.where(ok, pobs[g].to(dt) - y_hat[g].to(dt), 0.0)
        z = torch.where(ok[:, :, None], zc[g].to(dt), 0.0)      # (B, S, E)
        c = z.transpose(1, 2) * r[:, None, :]                   # (B, E, S)
        lam, v = _eigh(_mm(c, z, low) + eye)
        vt = v.transpose(1, 2)
        w_mat = _mm(v * torch.sqrt((e - 1) / lam)[:, None, :], vt, low)
        cd = _mm(c, d[:, :, None], low)
        w = _mm(v * (1.0 / lam)[:, None, :], _mm(vt, cd, low), low)[:, :, 0]
        bg = members[rows].to(dt)
        mean = bg.mean(dim=1, keepdim=True)
        sigma = bg.std(dim=1, correction=0, keepdim=True)
        xc = norm_anom(members_corr[rows]).to(dt)
        wx = _mm(w_mat.transpose(1, 2), xc[:, :, None], low)[:, :, 0]
        inc = sigma * wx + bratios[rows].to(dt)[:, None] * (xc * w).sum(
            dim=1, keepdim=True)
        ana = (mean + inc).to(torch.float64)
        keep = ok.any(dim=1)[:, None] & torch.isfinite(ana).all(
            dim=1, keepdim=True)
        out[rows] = torch.where(keep, ana, members[rows].to(torch.float64))
    return out
