"""gridpp_tpu_torch.EnsiPipeline: ensemble OI (EnSI), served through
EnsiPipeline.serve_stream (numpy in, numpy out).

Configuration keys: `structure` ({"kind": "barnes", "h"}), `max_points`,
`candidates`, `smoothing` ({"statistic": "mean", "halfwidth"}, 0: none),
`members` and `psigmas`. A cycle is (members (Y, X, E), pobs (P,),
psigmas (P,)).
"""
from __future__ import annotations

import numpy as np
import torch

from gpbench.harness import compare
from gpbench.reference import ensi, stencil


def build(config, traffic, device):
    import gridpp_tpu_torch as gt
    p = len(traffic.plats)
    if config["smoothing"]["statistic"] != "mean":
        raise ValueError("the reference smooths with the mean")
    return gt.EnsiPipeline(
        gt.Grid(traffic.lats, traffic.lons),
        gt.Points(traffic.plats, traffic.plons, np.zeros(p), np.zeros(p)),
        gt.BarnesStructure(float(config["structure"]["h"])),
        halfwidth=int(config["smoothing"]["halfwidth"]),
        statistic=gt.Statistic.Mean, max_points=int(config["max_points"]),
        candidates=int(config["candidates"]), device=device)


def counters(program) -> dict:
    return {}


class Check(compare.Check):
    _all_valid = None   # the selection while every obs is valid

    def analyses(self, i: int, low: bool = False):
        field, pobs, psig = self.t.inputs(i)
        ny, nx, e = field.shape
        x = torch.as_tensor(field, device=self.dev).to(torch.float64)
        if self.hw > 0:
            x = torch.stack([stencil.mean(x[:, :, m], self.hw)
                             for m in range(e)], dim=2)
        flat = x.reshape(ny * nx, e)
        y_hat, y_anom = ensi.obs_anomalies(flat[self.nn])
        obs = torch.as_tensor(pobs, device=self.dev).to(torch.float64)
        sig = torch.as_tensor(psig, device=self.dev).to(torch.float64)
        ok = torch.isfinite(obs)
        if not bool(ok.all()):
            sel = self.selection(ok)
        else:
            if self._all_valid is None:
                self._all_valid = self.selection(ok)
            sel = self._all_valid
        ref = ensi.analysis(flat, sel.sel, sel.rho, obs, sig, y_hat, y_anom,
                            low)
        alt = ensi.analysis(flat[sel.rows], sel.alt_sel, sel.alt_rho, obs,
                            sig, y_hat, y_anom, low)
        return ref, sel.rows, alt
