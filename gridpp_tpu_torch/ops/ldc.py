"""local_distribution_correction on tensors (gridpp_tpu/ops/ldc.py;
reference src/api/local_distribution_correction.cpp).

Per gridpoint: gather the (observation, background) pairs within the
localization radius, build rho-weighted empirical quantile curves trimmed
to [min_quantile, max_quantile], then apply the reference's piecewise
precipitation rules. Here the per-gridpoint sorts and curve
interpolations run batched over blocks of gridpoints; padded slots sort
to the tail and the curve's tail is clamped by repetition, which
reproduces the reference's edge handling under gridpp's flat-interval
interpolation rules (ops/curves.piecewise_interp). The rho sums run in
float64 and are rounded once to f32, so a row's result does not depend on
the device or the block's shape. Torch ops on whatever device the tensors
lie, as they are XLA ops in gridpp_tpu, not a kernel port.
"""
from __future__ import annotations

import torch

from .curves import piecewise_interp

__all__ = ["ldc_block"]


def _weighted_curve(vals, rho, valid, d0, d1, minq, maxq):
    """The sorted trimmed curve (B, M+1) with a leading (0, 0) point and
    rho-cumsum quantiles normalized to [minq, maxq].

    The kept entries, sorted positions [d0, d1), move to the front in
    order, as gridpp_tpu's stable sort of the key (kept: pos, dropped:
    m + pos) moves them: that order is a shift by d0 (none when nothing is
    kept), taken here as a gather; the entries past the kept count are
    overwritten below."""
    b, m = vals.shape
    key = torch.where(valid, vals, torch.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    svals = torch.gather(vals, -1, order)
    srho = torch.gather(rho, -1, order)
    pos = torch.arange(m, device=vals.device)[None, :]
    d0, d1 = torch.clamp(d0, 0, m), torch.clamp(d1, 0, m)
    kcount = torch.clamp(d1 - d0, min=0)
    start = torch.where(kcount > 0, d0, 0)
    shift = torch.clamp(start[:, None] + pos, max=m - 1)
    cvals = torch.gather(svals, -1, shift)
    crho = torch.gather(srho, -1, shift)
    in_curve = pos < kcount[:, None]
    # clamp the tail by repeating the last kept element
    last = torch.clamp(kcount - 1, min=0)
    lastv = torch.gather(cvals, -1, last[:, None])
    cvals = torch.where(in_curve, cvals, lastv)
    crho = torch.where(in_curve, crho, 0.0)
    # running sums in float64, rounded once to f32: sums of f32 rho this
    # short are exact in float64, so the sums do not depend on the
    # summation order (a card's scan, the CPU's, a block's shape), which
    # the ill-conditioned curves amplify (ROADMAP F11)
    csum64 = torch.cumsum(crho.to(torch.float64), dim=-1)
    csum = csum64.to(torch.float32)
    total = torch.gather(csum, -1, last[:, None])
    total = torch.where(total == 0, 1.0, total)
    quant = torch.minimum(minq + csum / total * (maxq - minq), maxq)
    # prepend the (0, 0) curve point
    zeros = torch.zeros((b, 1), dtype=cvals.dtype, device=vals.device)
    curve_vals = torch.cat([zeros, cvals], dim=-1)
    curve_q = torch.cat([zeros, quant], dim=-1)
    return curve_vals, curve_q, lastv[:, 0], kcount


def ldc_block(background, rho, valid, obs_vals, fcst_vals, min_quantile,
              max_quantile, min_points: int):
    """background: (B,); rho/valid: (B, M); obs_vals/fcst_vals: (B, M)
    (candidate x time flattened). Returns the corrected (B,). The
    quantiles are f32 scalars, as in gridpp_tpu's traced call."""
    min_quantile, max_quantile = (
        torch.tensor(float(q), dtype=torch.float32, device=rho.device)
        for q in (min_quantile, max_quantile))
    pair_valid = (valid & torch.isfinite(obs_vals)
                  & torch.isfinite(fcst_vals) & (obs_vals >= 0)
                  & (fcst_vals >= 0))
    rho_m = torch.where(pair_valid, rho, 0.0)
    count = torch.sum(pair_valid, dim=-1)
    sum_rho = torch.sum(rho_m.to(torch.float64), dim=-1).to(torch.float32)
    # f32 products truncated toward zero, as XLA converts them
    d0 = (count.to(torch.float32) * min_quantile).to(torch.int64)
    d1 = (count.to(torch.float32) * max_quantile).to(torch.int64)

    ref_c, ref_q, ref_last, kcount = _weighted_curve(
        obs_vals, rho_m, pair_valid, d0, d1, min_quantile, max_quantile)
    fcst_c, fcst_q, fcst_last, _ = _weighted_curve(
        fcst_vals, rho_m, pair_valid, d0, d1, min_quantile, max_quantile)
    # an empty trimmed curve is the lone (0, 0) point
    ref_last = torch.where(kcount > 0, ref_last, 0.0)
    fcst_last = torch.where(kcount > 0, fcst_last, 0.0)

    bg = background
    # rule 4: quantile mapping within the curve, blended by obs density
    q = piecewise_interp(bg, fcst_c, fcst_q)
    new_ref = piecewise_interp(q, ref_q, ref_c)
    w0 = 1 - torch.exp(-0.01 * sum_rho)
    rule4 = w0 * new_ref + (1 - w0) * bg
    # rule 3: above the curve, keep the end-of-curve bias
    rule3 = bg + (ref_last - fcst_last)
    # rule 2: no observed rain
    rule2 = torch.where((bg < 3 * fcst_last) | (bg < 0.1), 0.0, bg)

    out = torch.where(bg < 0.01, 0.0,
                      torch.where(ref_last <= 0, rule2,
                                  torch.where(bg >= fcst_last, rule3,
                                              rule4)))
    ok = (count >= min_points) & torch.isfinite(bg)
    return torch.where(ok, out, bg)
