"""Where a gridpp_tpu_torch serving cycle spends its time on a CUDA card.

    python3 tools/torch_profile.py [--path pipeline|ensi|ebesc|ebe|utem]
                                   [--n 2000] [--obs 10000] [--cycles 3]
                                   [--statistic Mean] [--halfwidth H]

The benchmark configuration (bench.py:57-69: Barnes 10 km, max_points=10,
ratios 0.1, seed 0). --path pipeline (the default) builds Pipeline
smoothed with --statistic at --halfwidth (default 7) and profiles its fast
(pratios None, the static ratios), general and resolve paths (the ratios
as a tensor; general and fast are captured CUDA graphs after the warm
cycle); --path ensi builds EnsiPipeline on a
normal(280, 5) ensemble of 10 members, psigmas 1.5, smoothed at
--halfwidth (default 0, bench.py:160-167), and profiles its fast
(all-valid) and general cycles; --path ebesc|ebe|utem builds that
MultiEnsiPipeline variant (bench.py:169-186). For each, a few warm cycles
run under torch.profiler, and it prints the host time per cycle, the
summed device (kernel) time per cycle, the device's idle share over the
window, and the kernels that take the most device time. Needs a CUDA card.
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

PATHS = ("pipeline", "ensi", "ebesc", "ebe", "utem")
MEMBERS = 10  # bench.py:161


def profile(name, cycle, cycles, top):
    """Profile `cycles` warm calls of cycle(i) and print the summary."""
    cycle(0)  # warm: builds, caches the general path's gain rows
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(cycles):
            cycle(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"\n== {name}: host {wall / cycles * 1e3:.3f} ms/cycle, "
          f"device busy {dev_us / cycles / 1e3:.3f} ms/cycle, "
          f"idle share {1 - dev_us / 1e6 / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / cycles / 1e3:9.3f} "
              f"ms  x{e.count // cycles:<4d} {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=PATHS, default="pipeline")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--obs", type=int, default=10000)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--statistic", default="Mean",
                    help="smoothing statistic: a name of gt.Statistic")
    ap.add_argument("--halfwidth", type=int, default=None,
                    help="smoothing halfwidth (default 7 for pipeline, 0 "
                         "for ensi)")
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
    structure = gt.BarnesStructure(10000.0)
    statistic = getattr(gt.Statistic, args.statistic)
    obs = [torch.as_tensor(pobs + np.float32(i), device=dev)
           for i in range(args.cycles)]
    rat = torch.as_tensor(ratios, device=dev)

    t0 = time.perf_counter()
    if args.path == "pipeline":
        h = 7 if args.halfwidth is None else args.halfwidth
        pipe = gt.Pipeline(grid, points, structure, halfwidth=h,
                           statistic=statistic, max_points=10,
                           ratios=ratios, device=dev)
        torch.cuda.synchronize()
        print(f"host set-up {time.perf_counter() - t0:.3f} s")
        bg = torch.as_tensor(background, device=dev)
        for path in ("fast", "general", "resolve"):
            # fast on the static ratios as pratios=None: a tensor pratios
            # is copied down to be compared with them (a host wait)
            pr = None if path == "fast" else rat
            profile(path, lambda i: pipe.run_device(
                bg, obs[i], pr, assume_valid=True, path=path),
                args.cycles, args.top)
        return

    ens = torch.as_tensor(rng.normal(280, 5, (n, n, MEMBERS)).astype(
        np.float32), device=dev)
    if args.path == "ensi":
        h = 0 if args.halfwidth is None else args.halfwidth
        pipe = gt.EnsiPipeline(grid, points, structure, halfwidth=h,
                               statistic=statistic, max_points=10,
                               device=dev)
        torch.cuda.synchronize()
        print(f"host set-up {time.perf_counter() - t0:.3f} s")
        psig = torch.full((p,), 1.5, device=dev)
        for label, valid in (("ensi fast", True), ("ensi general", False)):
            profile(label, lambda i: pipe.run_device(
                ens, obs[i], psig, assume_valid=valid), args.cycles,
                args.top)
        return

    pipe = gt.MultiEnsiPipeline(grid, points, structure, variant=args.path,
                                max_points=10, device=dev)
    torch.cuda.synchronize()
    print(f"host set-up {time.perf_counter() - t0:.3f} s")
    pobs_e = torch.as_tensor((pback[:, None] + rng.normal(
        0, 1, (p, MEMBERS))).astype(np.float32), device=dev)
    if args.path == "utem":
        def cycle(i):
            return pipe.run_device(ens, obs[i], rat, ens)
    else:
        def cycle(i):
            return pipe.run_device(ens, pobs_e + 0.01 * i, rat,
                                   ens if args.path == "ebe" else None)
    profile(args.path, cycle, args.cycles, args.top)


if __name__ == "__main__":
    main()
