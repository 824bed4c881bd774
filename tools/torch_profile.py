"""Where a gridpp_tpu_torch Pipeline cycle spends its time on a CUDA card.

    python3 tools/torch_profile.py [--n 2000] [--obs 10000] [--cycles 3]
                                   [--statistic Mean]

Builds Pipeline at the benchmark configuration (bench.py:57-69: Barnes
10 km, max_points=10, neighbourhood Mean h=7, ratios 0.1, seed 0; another
smoothing statistic with --statistic, e.g. Max), then for
each path (fast, general, resolve) profiles a few warm cycles with
torch.profiler and prints: the host time per cycle, the summed device
(kernel) time per cycle, the device's idle share over the window, and the
kernels that take the most device time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import gridpp_tpu_torch as gt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--obs", type=int, default=10000)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--statistic", default="Mean",
                    help="smoothing statistic: a name of gt.Statistic")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", torch.cuda.current_device())
    n, p = args.n, args.obs
    rng = np.random.default_rng(0)
    lats, lons = np.meshgrid(np.linspace(55, 62, n), np.linspace(5, 12, n),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    points = gt.Points(rng.uniform(55, 62, p), rng.uniform(5, 12, p),
                       np.zeros(p), np.zeros(p))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    pback = background.reshape(-1)[grid.nearest_map(points.lats,
                                                    points.lons)]
    pobs = pback + rng.normal(0, 1, p).astype(np.float32)
    ratios = np.full(p, 0.1, np.float32)
    t0 = time.perf_counter()
    pipe = gt.Pipeline(grid, points, gt.BarnesStructure(10000.0),
                       halfwidth=7,
                       statistic=getattr(gt.Statistic, args.statistic),
                       max_points=10,
                       ratios=ratios, device=dev)
    torch.cuda.synchronize()
    print(f"host set-up {time.perf_counter() - t0:.3f} s")
    bg = torch.as_tensor(background, device=dev)
    obs = [torch.as_tensor(pobs + np.float32(i), device=dev)
           for i in range(args.cycles)]
    rat = torch.as_tensor(ratios, device=dev)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for path in ("fast", "general", "resolve"):
        def cycle(i):
            return pipe.run_device(bg, obs[i], rat, assume_valid=True,
                                   path=path)
        cycle(0)  # warm: builds, caches the general path's gain rows
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.cycles):
                cycle(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in events)
        print(f"\n== {path}: host {wall / args.cycles * 1e3:.3f} ms/cycle, "
              f"device busy {dev_us / args.cycles / 1e3:.3f} ms/cycle, "
              f"idle share {1 - dev_us / 1e6 / wall:.3f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[
                :args.top]:
            print(f"  {e.self_device_time_total / args.cycles / 1e3:9.3f} "
                  f"ms  x{e.count // args.cycles:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
