"""gridpp_tpu_torch.Pipeline: neighbourhood smoothing and deterministic
OI, served through Pipeline.serve_stream (numpy in, numpy out).

Configuration keys: `structure` ({"kind": "barnes", "h"}), `max_points`,
`candidates`, `smoothing` ({"statistic": "mean", "halfwidth"}) and the
static `ratios`. A cycle is (background (Y, X), pobs (P,)); pratios are
not sent, so the static ratios serve: the fast path while every obs is
finite, the general path (its guard rebuilding the gain rows when the
valid set changes) otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from gpbench.harness import compare
from gpbench.reference import geometry, oi, stencil


def build(config, traffic, device):
    import gridpp_tpu_torch as gt
    p = len(traffic.plats)
    if config["smoothing"]["statistic"] != "mean":
        raise ValueError("the reference smooths with the mean")
    return gt.Pipeline(
        gt.Grid(traffic.lats, traffic.lons),
        gt.Points(traffic.plats, traffic.plons, np.zeros(p), np.zeros(p)),
        gt.BarnesStructure(float(config["structure"]["h"])),
        halfwidth=int(config["smoothing"]["halfwidth"]),
        statistic=gt.Statistic.Mean, max_points=int(config["max_points"]),
        candidates=int(config["candidates"]),
        ratios=np.full(p, float(config["ratios"]), np.float32),
        device=device)


def counters(program) -> dict:
    return {"rebuilds": int(program.rebuilds)}


class Check(compare.Check):
    def __init__(self, config, traffic, device):
        super().__init__(config, traffic, device)
        self.sxyz = torch.as_tensor(geometry.xyz(traffic.plats,
                                                 traffic.plons), device=device)
        self.ratios = torch.full((len(traffic.plats),),
                                 float(np.float32(config["ratios"])),
                                 dtype=torch.float64, device=device)
        self._gains = {}

    def _gained(self, ok, low):
        """(Selection, gains, alt gains), kept while obs stay all valid."""
        key = (bool(ok.all()), low)
        if key[0] and key in self._gains:
            return self._gains[key]
        sel = self.selection(ok)
        got = (sel, oi.gains(sel.sel, sel.rho, self.sxyz, self.ratios,
                             self.h, low),
               oi.gains(sel.alt_sel, sel.alt_rho, self.sxyz, self.ratios,
                        self.h, low))
        if key[0]:
            self._gains[key] = got
        return got

    def analyses(self, i: int, low: bool = False):
        field, pobs = self.t.inputs(i)
        flat = stencil.mean(torch.as_tensor(field, device=self.dev),
                            self.hw).reshape(-1)
        obs = torch.as_tensor(pobs, device=self.dev).to(torch.float64)
        innov = obs - flat[self.nn]
        sel, x, xa = self._gained(torch.isfinite(innov), low)
        ref = oi.analysis(flat, sel.sel, x, innov, low)
        alt = oi.analysis(flat[sel.rows], sel.alt_sel, xa, innov, low)
        return ref, sel.rows, alt
