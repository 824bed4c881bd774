"""Dense-network serving-parity sweep: every pipeline against its API
function, over seeds.

An 80 x 80 geodetic grid, 300 obs (all valid), BarnesStructure(30 km),
max_points=10, the default candidates, e=8 members. Each of the five
pipelines (Pipeline, EnsiPipeline, MultiEnsiPipeline ebesc, ebe, utem),
built on --device, must match at every gridpoint within 1e-2 (the solve's
numerics):
- its API function on the host route (the top-level function);
- its module function on the device route (gridpp_tpu_torch.api.<module>
  with --device as torch's default device; on the CPU that is the host
  route again, under `api._common.host()`).

    python -m gridpp_tpu_torch.tools.sweep_parity [seed_lo seed_hi]
        [--device cuda|cpu]

Prints the worst difference per pipeline and seed; exits 1 past 1e-2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TOL = 1e-2
PIPELINES = ("pipeline", "ensi", "ebesc", "ebe", "utem")


def problem(gt, seed, n=80, n_obs=300):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n),
                             np.linspace(5, 8, n), indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 58, n_obs), rng.uniform(5, 8, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    pback = gt.nearest(grid, pts, background)
    pobs = (pback + rng.normal(0, 2, n_obs)).astype(np.float32)
    ratios = np.full(n_obs, 0.2, np.float32)
    structure = gt.BarnesStructure(30000.0)
    return grid, pts, background, pback, pobs, ratios, structure


def _device_route(dev):
    """The module functions' device route on dev: dev as torch's default
    device, or the host route on the CPU."""
    from ..api._common import host
    return torch.device(dev) if dev.type != "cpu" else host()


def run_seed(seed, device, mp=10, e=8):
    """{pipeline: (max|pipeline - host API|, max|pipeline - device
    route|)} for one seed, the pipelines on device."""
    import gridpp_tpu_torch as gt
    from ..api import oi, oi_ensi, oi_ensi_multi

    dev = torch.device(device)
    grid, pts, background, pback, pobs, ratios, structure = problem(gt, seed)
    n_obs = pts.size()
    rng = np.random.default_rng(1000 + seed)

    def both(top, module, *args):
        host = top(*args)
        with _device_route(dev):
            card = module(*args)
        return host, card

    calls = {}
    calls["pipeline"] = (
        gt.Pipeline(grid, pts, structure, halfwidth=0, max_points=mp,
                    device=dev)(background, pobs, ratios),
        both(gt.optimal_interpolation, oi.optimal_interpolation, grid,
             background, pts, pobs, ratios, pback, structure, mp))

    bg3 = (np.repeat(background[:, :, None], e, axis=2)
           + rng.normal(0, 1, background.shape + (e,))).astype(np.float32)
    idx = grid.nearest_map(pts.lats, pts.lons)
    pb3 = bg3.reshape(-1, e)[idx]
    psig = np.full(n_obs, 1.5, np.float32)
    calls["ensi"] = (
        gt.EnsiPipeline(grid, pts, structure, max_points=mp, device=dev)(
            bg3, pobs, psig),
        both(gt.optimal_interpolation_ensi,
             oi_ensi.optimal_interpolation_ensi, grid, bg3, pts, pobs, psig,
             pb3, structure, mp))

    bgc = (np.repeat(background[:, :, None], e, axis=2)
           + rng.normal(0, 1, background.shape + (e,))).astype(np.float32)
    pbc = bgc.reshape(-1, e)[idx]
    bratios = np.ones(grid.size()[0] * grid.size()[1], np.float32)
    pobs_e = (pb3 + rng.normal(0, 1, (n_obs, e))).astype(np.float32)

    def multi(variant):
        return gt.MultiEnsiPipeline(grid, pts, structure, variant=variant,
                                    max_points=mp, device=dev)

    calls["ebesc"] = (
        multi("ebesc")(bg3, pobs_e, ratios),
        both(gt.optimal_interpolation_ensi_multi_ebesc,
             oi_ensi_multi.optimal_interpolation_ensi_multi_ebesc, grid,
             bratios, bg3, pts, pobs_e, ratios, pb3, structure, mp))
    calls["ebe"] = (
        multi("ebe")(bg3, pobs_e, ratios, background_corr=bgc),
        both(gt.optimal_interpolation_ensi_multi_ebe,
             oi_ensi_multi.optimal_interpolation_ensi_multi_ebe, grid,
             bratios, bg3, bgc, pts, pobs_e, ratios, pb3, pbc, structure,
             mp))
    calls["utem"] = (
        multi("utem")(bg3, pobs, ratios, background_corr=bgc),
        both(gt.optimal_interpolation_ensi_multi_utem,
             oi_ensi_multi.optimal_interpolation_ensi_multi_utem, grid,
             bratios, bg3, bgc, pts, pobs, ratios, pb3, pbc, structure, mp))
    return {k: (float(np.abs(got - host).max()),
                float(np.abs(got - card).max()))
            for k, (got, (host, card)) in calls.items()}


def sweep(seeds, device, log=print):
    """run_seed over seeds, printed a line a seed; returns {seed: rows}."""
    out = {}
    for seed in seeds:
        rows = run_seed(seed, device)
        bad = [k for k, v in rows.items() if not max(v) < TOL]
        log(f"seed {seed}: " + "  ".join(
            f"{k}=host {h:.3g} / device route {c:.3g}"
            for k, (h, c) in rows.items())
            + ("  <-- FAIL" if bad else ""), flush=True)
        out[seed] = rows
    return out


def worst(result):
    """The worst difference over every seed, pipeline and route."""
    return max(max(v) for rows in result.values() for v in rows.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seed_lo", nargs="?", type=int, default=0)
    ap.add_argument("seed_hi", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("sweep_parity: no CUDA card (pass --device cpu)",
              file=sys.stderr)
        return 2
    w = worst(sweep(range(args.seed_lo, args.seed_hi), args.device))
    ok = w < TOL
    print(f"worst {w:.3g} over seeds {args.seed_lo}-{args.seed_hi - 1} x "
          f"{len(PIPELINES)} pipelines x 2 routes (bar {TOL})")
    print("PARITY " + ("PASS" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
