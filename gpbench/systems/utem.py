"""gridpp_tpu_torch.MultiEnsiPipeline(variant="utem"): ensemble OI whose
correlations come from a second ensemble (gridpp's
optimal_interpolation_ensi_multi_utem), served through
MultiEnsiPipeline.serve_stream (numpy in, numpy out).

Configuration keys: `structure` ({"kind": "barnes", "h"}), `max_points`,
`candidates`, `smoothing` (halfwidth 0: utem smooths nothing), `members`
(the background's and background_corr's), `pratios` and `bratios` (one
value each, at every station and gridpoint) and `allow_extrapolation`
(true). A cycle is (background (Y, X, E), pobs (P,), pratios (P,),
background_corr (Y, X, E)).

The traffic generator makes (background, pobs). background_corr comes from
a pool of its own: POOL slots drawn at build from the seed, on a generator
stream of their own (`corr_pool`), slot s beside the traffic's background
slot s. The served tuple pairs them by the background array itself, one of
the traffic's own pool arrays, and not by counting cycles; the Check takes
cycle i's slot i mod POOL. pratios are one array, the same every cycle.
"""
from __future__ import annotations

import numpy as np
import torch

from gpbench.harness import compare
from gpbench.harness.traffic import POOL
from gpbench.reference import utem

CORR_STREAM = 3     # the seed's stream of the correlation ensemble


def corr_pool(config, traffic, device) -> list:
    """The POOL host arrays (Y, X, E) of background_corr, drawn once a
    traffic (kept on it) from its seed: normal with the configuration's
    `field` parameters, one draw a slot on the device given."""
    pool = getattr(traffic, "utem_corr", None)
    if pool is None:
        state = np.random.SeedSequence([traffic.seed, CORR_STREAM])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state.generate_state(1, np.uint64)[0]) >> 1)
        f = config["field"]
        shape = (traffic.ny, traffic.nx, int(config["members"]))
        pool = [torch.normal(float(f["mean"]), float(f["std"]), shape,
                             generator=gen, device=device).cpu().numpy()
                for _ in range(POOL)]
        traffic.utem_corr = pool
    return pool


def _checked(config) -> None:
    if int(config["smoothing"]["halfwidth"]):
        raise ValueError("utem smooths nothing")
    if not config["allow_extrapolation"]:
        raise ValueError("the reference takes allow_extrapolation true")


class Served:
    """The program and what completes a traffic cycle into its four
    arrays."""

    def __init__(self, pipe, traffic, pratios, pool):
        self.pipe = pipe
        self.pratios = pratios
        self.pool = pool
        self.slot = {id(f): s for s, f in enumerate(traffic.fields)}

    def serve_stream(self, cycles):
        pr, pool, slot = self.pratios, self.pool, self.slot
        return self.pipe.serve_stream(
            (bg, pobs, pr, pool[slot[id(bg)]]) for bg, pobs in cycles)


def build(config, traffic, device):
    import gridpp_tpu_torch as gt
    _checked(config)
    p = len(traffic.plats)
    pipe = gt.MultiEnsiPipeline(
        gt.Grid(traffic.lats, traffic.lons),
        gt.Points(traffic.plats, traffic.plons, np.zeros(p), np.zeros(p)),
        gt.BarnesStructure(float(config["structure"]["h"])),
        variant="utem", max_points=int(config["max_points"]),
        allow_extrapolation=True, candidates=int(config["candidates"]),
        bratios=np.full((traffic.ny, traffic.nx), float(config["bratios"]),
                        np.float32), device=device)
    return Served(pipe, traffic,
                  np.full(p, float(config["pratios"]), np.float32),
                  corr_pool(config, traffic, device))


def counters(program) -> dict:
    return {}


class Check(compare.Check):
    _all_valid = None   # the selection while every obs is valid

    def __init__(self, config, traffic, device):
        _checked(config)
        super().__init__(config, traffic, device)
        self.pool = corr_pool(config, traffic, device)
        p = len(traffic.plats)
        self.pratios = torch.full((p,), float(config["pratios"]),
                                  dtype=torch.float64, device=device)
        self.bratios = torch.full((traffic.ny * traffic.nx,),
                                  float(config["bratios"]),
                                  dtype=torch.float64, device=device)

    def analyses(self, i: int, low: bool = False):
        field, pobs = self.t.inputs(i)
        ny, nx, e = field.shape
        flat = torch.as_tensor(field, device=self.dev).reshape(ny * nx, e)
        corr = torch.as_tensor(self.pool[i % POOL],
                               device=self.dev).reshape(ny * nx, e)
        y_hat, zc = utem.obs_terms(flat[self.nn], corr[self.nn])
        obs = torch.as_tensor(pobs, device=self.dev).to(torch.float64)
        ok = torch.isfinite(obs)
        if not bool(ok.all()):
            sel = self.selection(ok)
        else:
            if self._all_valid is None:
                self._all_valid = self.selection(ok)
            sel = self._all_valid
        ref = utem.analysis(flat, corr, sel.sel, sel.rho, obs, self.pratios,
                            y_hat, zc, self.bratios, low)
        alt = utem.analysis(flat[sel.rows], corr[sel.rows], sel.alt_sel,
                            sel.alt_rho, obs, self.pratios, y_hat, zc,
                            self.bratios[sel.rows], low)
        return ref, sel.rows, alt
