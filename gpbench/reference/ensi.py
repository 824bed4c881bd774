"""Ensemble OI, EnSI, the local ensemble transform (reference
oi_ensi.cpp:114-568).

At each obs o: the members' mean over its finite members y_hat(o) at the
obs' nearest gridpoint, and the members' anomalies Y(o, e) from it. For
each gridpoint, with its selected stations i = 1..S (the S highest rho
among the valid ones) and E members:
    r_i   = rho(g, o_i) / sigma_i^2              (the localised R^-1)
    Pinv  = Y^T diag(r) Y + (E - 1) I            (E x E)
    W     = ((E - 1) Pinv^-1)^(1/2)              (symmetric square root)
    w     = Pinv^-1 Y^T diag(r) (obs - y_hat)
    x_e   = member e - the members' mean at g
    analysis_e = mean + sum_k x_k (W[k, e] + w[k])
A gridpoint with no valid station in range keeps its members. Float64 with
the square root and inverse from `torch.linalg.eigh`, as gridpp's
armadillo solve is in double.

`low=True` is the control: the same in float32 with every matrix product
in TF32, the step below the configuration's float32 with TF32 off: each
product's operands are rounded to TF32 (`tf32`) and the product is summed
in float32.
"""
from __future__ import annotations

import torch

from . import tf32

ROWS_PER_BLOCK = 1 << 17
EIGH_BATCH = 1 << 13   # cusolver's batched eigh refuses 2^17 10 x 10


def obs_anomalies(pback):
    """(y_hat (P,), Y (P, E)) from the members at the obs (P, E)."""
    fin = torch.isfinite(pback)
    cnt = fin.sum(dim=1)
    y_hat = torch.where(fin, pback, 0.0).sum(dim=1) / cnt.clamp(min=1)
    y_hat = torch.where(cnt > 0, y_hat, torch.nan)
    anom = torch.where(fin & torch.isfinite(y_hat)[:, None],
                       pback - y_hat[:, None], pback)
    return y_hat, anom


def _eigh(a):
    """torch.linalg.eigh in batches of at most EIGH_BATCH matrices."""
    parts = [torch.linalg.eigh(a[i:i + EIGH_BATCH])
             for i in range(0, a.shape[0], EIGH_BATCH)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _mm(u, v, low: bool):
    return torch.matmul(tf32(u), tf32(v)) if low else torch.matmul(u, v)


def analysis(members, sel, rho, pobs, psig, y_hat, y_anom,
             low: bool = False):
    """Analysis (M, E) float64 of the rows of members (M, E) with their
    selections sel/rho (M, S) (-1: no station). pobs, psig, y_hat: (P,);
    y_anom: (P, E). low: the TF32 control."""
    dt = torch.float32 if low else torch.float64
    m, e = members.shape
    out = torch.empty((m, e), dtype=torch.float64, device=members.device)
    eye = torch.eye(e, dtype=dt, device=members.device)
    for a in range(0, m, ROWS_PER_BLOCK):
        s = sel[a:a + ROWS_PER_BLOCK]
        ok = s >= 0
        g = s.clamp(min=0)
        r = torch.where(ok, rho[a:a + ROWS_PER_BLOCK].to(dt)
                        / psig[g].to(dt) ** 2, 0.0)
        dv = torch.where(ok, pobs[g].to(dt) - y_hat[g].to(dt), 0.0)
        y = torch.where(ok[:, :, None], y_anom[g].to(dt), 0.0)
        c = y.transpose(1, 2) * r[:, None, :]                # (B, E, S)
        pinv = _mm(c, y, low) + (e - 1) * eye
        lam, v = _eigh(pinv)
        vt = v.transpose(1, 2)
        w_mat = _mm(v * torch.sqrt((e - 1) / lam)[:, None, :], vt, low)
        cv = _mm(c, dv[:, :, None], low)
        w = _mm(v * (1.0 / lam)[:, None, :], _mm(vt, cv, low), low)[:, :, 0]
        bg = members[a:a + ROWS_PER_BLOCK].to(dt)
        mean = bg.mean(dim=1, keepdim=True)
        x = bg - mean
        inc = _mm(w_mat, x[:, :, None], low)[:, :, 0] \
            + (x * w).sum(dim=1, keepdim=True)
        ana = (mean + inc).to(torch.float64)
        keep = ok.any(dim=1)[:, None] & torch.isfinite(ana).all(
            dim=1, keepdim=True)
        out[a:a + ROWS_PER_BLOCK] = torch.where(
            keep, ana, members[a:a + ROWS_PER_BLOCK].to(torch.float64))
    return out
