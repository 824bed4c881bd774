"""The comparison that decides `correct`, the reference's side.

Selections: the reference ranks stations by float64 rho; the program
ranks by its own float32 rho. Where a gridpoint's S-th and (S + 1)-th
admitted stations lie within TIE (relative) of each other in rho, either
set is gridpp's answer to rounding: the reference then also works out the
analysis with the two swapped, and the program's value is judged against
the nearer of the two. TIE is 1e-4, some five times the largest relative
rho error of float32 coordinates and arithmetic at the localization
distance (about 2e-5), and far below any real difference in rho.

Errors: per gridpoint the largest absolute difference over its values
(members), infinite where the program's value is not finite. A cell's
readings over its checked cycles: `max_abs_err_K`, the largest, and
`rms_err_K`, the root mean square.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import geometry

TIE = 1e-4


class Selection:
    """Each gridpoint's S admitted stations of highest rho, and the
    swapped set of the gridpoints on a near tie."""

    def __init__(self, ranking, ok, s: int, rerank):
        """ranking: (sel, rho) of k > s ranked stations a gridpoint;
        ok: (P,) bool tensor of the admitted stations; rerank(rows, ok) ->
        (sel, rho) ranking s + 1 stations of those rows from scratch (for
        rows whose ranking ran short of admitted stations)."""
        sel, rho, short = geometry.first_valid(*ranking, ok, s)
        if bool(short.any()):
            rows = torch.nonzero(short)[:, 0]
            sel[rows], rho[rows] = rerank(rows.cpu().numpy(), ok)
        self.sel, self.rho = sel[:, :s], rho[:, :s]
        near = (sel[:, s] >= 0) & (rho[:, s - 1] - rho[:, s]
                                   <= TIE * rho[:, s - 1])
        self.rows = torch.nonzero(near)[:, 0]
        self.alt_sel = sel[self.rows][:, :s].clone()
        self.alt_rho = rho[self.rows][:, :s].clone()
        self.alt_sel[:, s - 1] = sel[self.rows, s]
        self.alt_rho[:, s - 1] = rho[self.rows, s]


class Check:
    """The reference's side of a cell's comparison, for one run's network:
    the stations ranked once, then each checked cycle's analyses
    (`analyses(i, low)`, a system's own) against the program's output or
    the control's."""

    SLACK = 3   # stations ranked a gridpoint, x max_points, when obs miss

    def __init__(self, config, traffic, device):
        st = config["structure"]
        if st["kind"] != "barnes":
            raise ValueError("the reference takes the Barnes structure")
        self.t, self.dev = traffic, device
        self.h = float(st["h"])
        self.s = int(config["max_points"])
        self.hw = int(config["smoothing"]["halfwidth"])
        self.nn = torch.as_tensor(traffic.nn, device=device)
        k = (self.SLACK * self.s if traffic.missing else self.s) + 1
        self.ranking = geometry.ranked(traffic.lats, traffic.lons,
                                       traffic.plats, traffic.plons, self.h,
                                       k, device)

    def _rerank(self, rows, ok):
        return geometry.ranked(self.t.lats, self.t.lons, self.t.plats,
                               self.t.plons, self.h, self.s + 1, self.dev,
                               ok=ok.cpu().numpy(), rows=rows)

    def selection(self, ok) -> Selection:
        return Selection(self.ranking, ok, self.s, self._rerank)

    def analyses(self, i: int, low: bool = False):
        """Cycle i's reference analysis (N, ...), its near-tie rows and
        their alternative analyses; low: the control."""
        raise NotImplementedError

    def errors(self, i: int, out) -> torch.Tensor:
        ref, rows, alt = self.analyses(i)
        return errors(torch.as_tensor(out, device=self.dev), ref, rows, alt)

    def control_errors(self, i: int) -> torch.Tensor:
        ctl = self.analyses(i, low=True)[0]
        ref, rows, alt = self.analyses(i)
        return errors(ctl, ref, rows, alt)


def errors(out, ref, alt_rows, alt):
    """Per gridpoint error (N,) float64 of the program's output (N, ...)
    against ref (N, ...), and against alt (R, ...) on alt_rows (R,)."""
    p = out.reshape(ref.shape[0], -1).to(torch.float64)
    r = ref.reshape(ref.shape[0], -1)
    err = (p - r).abs().amax(dim=1)
    err = torch.where(torch.isfinite(p).all(dim=1), err, math.inf)
    if alt_rows.numel():
        e2 = (p[alt_rows] - alt.reshape(alt_rows.shape[0], -1)).abs().amax(
            dim=1)
        err[alt_rows] = torch.minimum(err[alt_rows], e2)
    return err


def readings(errs) -> dict:
    """The numbers compared, over a list of per-gridpoint error tensors."""
    if not errs:
        return {"max_abs_err_K": math.inf, "rms_err_K": math.inf}
    e = torch.cat([x.reshape(-1) for x in errs])
    return {"max_abs_err_K": float(e.max()),
            "rms_err_K": float(torch.sqrt(torch.mean(e * e)))}


def judged(read: dict, limits: dict) -> dict:
    """Each reading beside its limit: {name: {"value", "limit"}}."""
    return {k: {"value": read[k], "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in checks.values())
