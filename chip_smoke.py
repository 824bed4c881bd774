"""Smoke run of gridpp_tpu_torch's serving path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. In order it:
1. requires a CUDA card (there is no CPU path) and prints its name and
   power limit; TF32 is switched off for matmul and cuDNN;
2. builds the kernels (K1, csrc/neighbourhood_mean.cu) and the native host
   library, and prints the build times and the compiler's resource report;
3. holds K1 against its plain PyTorch twin on the card (rtol 1e-5,
   atol 1e-4) for Mean, Sum and Count at 2000 x 2000 with and without 10%
   NaN, at small edge shapes and on a batched input, and times both at
   2000 x 2000, h=7;
4. builds Pipeline at the benchmark configuration (2000 x 2000 grid, 10,000
   obs, BarnesStructure(10 km), max_points=10, neighbourhood Mean h=7,
   ratios 0.1, seed 0) on the card and prints the host set-up time;
5. runs cycles of the fast, general and resolve paths on distinct inputs,
   plus one cycle with a third of the obs missing, and checks: finite
   output, general == resolve bit for bit, fast within 1e-3 of general,
   and one K1 launch per cycle; prints each path's median cycle time;
6. runs a 256 x 256 cut of the same problem through the whole slice on the
   card and on the CPU (plain twins) and requires max|d| <= 1e-3.

Any failed check raises. The line before the last is a JSON record of the
kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K1_RTOL, K1_ATOL = 1e-5, 1e-4    # tests/test_pallas_stencil.py:36-38
FAST_TOL = 1e-3                  # tests/test_pipeline_consistency.py:86
CARD_CPU_TOL = 1e-3
CYCLES = 5


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def field(rng, shape, nan_frac):
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def event_ms(fn, reps=50):
    """Mean device time of fn() over reps launches, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_problem(n=2000, p=10000):
    """The configuration of bench.py:57-69, seed 0."""
    rng = np.random.default_rng(0)
    lats, lons = np.meshgrid(np.linspace(55, 62, n), np.linspace(5, 12, n),
                             indexing="ij")
    plats = rng.uniform(55, 62, p)
    plons = rng.uniform(5, 12, p)
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    noise = rng.normal(0, 1, p).astype(np.float32)
    return lats, lons, plats, plons, background, noise


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this run needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    import gridpp_tpu_torch as gt
    from gridpp_tpu_torch import native
    from gridpp_tpu_torch._build import build_log
    from gridpp_tpu_torch.ops import stencil

    dev = torch.device("cuda", torch.cuda.current_device())

    # -- 2. build --------------------------------------------------------
    print("[build]", flush=True)
    t0 = time.perf_counter()
    lib = stencil.build_kernel()
    print(f"  K1 build {time.perf_counter() - t0:.3f} s", flush=True)
    print(build_log(lib), flush=True)
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "native host library built")
    print(f"  native build {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 3. K1 against its twin --------------------------------------------
    print("[K1 vs plain twin]", flush=True)
    rng = np.random.default_rng(1)
    cases = [((2000, 2000), 7, 0.0), ((2000, 2000), 7, 0.1),
             ((40, 60), 3, 0.1), ((17, 250), 7, 0.1), ((300, 129), 1, 0.1),
             ((31, 31), 0, 0.1), ((256, 129), 7, 0.1), ((160, 128), 3, 0.1),
             ((256, 300), 7, 0.1), ((3, 256, 300), 7, 0.1)]
    k1_err = 0.0
    for shape, h, nan_frac in cases:
        x = torch.as_tensor(field(rng, shape, nan_frac), device=dev)
        hy = min(h, shape[-2] - 1)
        hx = min(h, shape[-1] - 1)
        for stat in stencil.STATS:
            if h == 0:
                # h = 0 never launches K1 (neighbourhood's pass-through)
                got = gt.neighbourhood(x, 0, stat)
                want = gt.neighbourhood(x.cpu(), 0, stat).to(dev)
            else:
                got = stencil.neighbourhood_mean_cuda(x, hy, hx, stat)
                want = stencil.neighbourhood_mean_plain(x, hy, hx, stat)
            torch.cuda.synchronize()
            same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
            err = float(torch.nan_to_num(got - want).abs().max())
            ok = same_nan and bool(torch.allclose(
                got, want, rtol=K1_RTOL, atol=K1_ATOL, equal_nan=True))
            check(ok, f"K1 {shape} h={h} nan={nan_frac} stat={stat} "
                      f"max|d|={err:.3g}")
            k1_err = max(k1_err, err)

    lats, lons, plats, plons, background, noise = bench_problem()
    bg0 = torch.as_tensor(background, device=dev)
    mean = int(gt.Mean)
    k1_ms = event_ms(lambda: stencil.neighbourhood_mean_cuda(bg0, 7, 7,
                                                             mean))
    plain_ms = event_ms(lambda: stencil.neighbourhood_mean_plain(bg0, 7, 7,
                                                                 mean))
    print(f"  K1 2000x2000 h=7 Mean: kernel {k1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)

    # -- 4. Pipeline at the benchmark configuration ---------------------------
    print("[Pipeline 2000x2000, 10k obs]", flush=True)
    p = plats.size
    t0 = time.perf_counter()
    grid = gt.Grid(lats, lons)
    points = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    structure = gt.BarnesStructure(10000.0)
    idx = grid.nearest_map(points.lats, points.lons)
    pback = background.reshape(-1)[idx]
    pobs = pback + noise
    ratios = np.full(p, 0.1, np.float32)
    torch.cuda.reset_peak_memory_stats()
    pipe = gt.Pipeline(grid, points, structure, halfwidth=7,
                       statistic=gt.Mean, max_points=10, ratios=ratios,
                       device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"  host set-up {setup_s:.3f} s (shortlist, tile tables, static "
          f"weights)", flush=True)

    # -- 5. cycles ---------------------------------------------------------
    bgs = [torch.as_tensor(background + np.float32(i), device=dev)
           for i in range(CYCLES)]
    obs = [torch.as_tensor(pobs + np.float32(i), device=dev)
           for i in range(CYCLES)]
    gap = pobs.copy()
    gap[::3] = np.nan
    gap = torch.as_tensor(gap, device=dev)
    rat = torch.as_tensor(ratios, device=dev)
    torch.cuda.synchronize()

    def run(path, i, po=None):
        t = time.perf_counter()
        out = pipe.run_device(bgs[i], obs[i] if po is None else po, rat,
                              assume_valid=po is None, path=path)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    stencil.neighbourhood_mean_cuda.launches = 0
    outs, times = {}, {}
    for path in ("fast", "general", "resolve"):
        res = [run(path, i) for i in range(CYCLES)]
        outs[path] = [r[0] for r in res]
        times[path] = [r[1] for r in res]
    gap_general, _ = run("general", 0, gap)
    gap_resolve, _ = run("resolve", 0, gap)
    launches = stencil.neighbourhood_mean_cuda.launches
    n_cycles = 3 * CYCLES + 2
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print("[checks]", flush=True)
    for path in outs:
        check(all(bool(torch.isfinite(o).all()) for o in outs[path]),
              f"{path}: every output finite, shape {tuple(outs[path][0].shape)}")
    for i in range(CYCLES):
        check(torch.equal(outs["general"][i], outs["resolve"][i]),
              f"cycle {i}: general == resolve bit for bit")
    check(torch.equal(gap_general, gap_resolve),
          "obs-gap cycle (rebuild): general == resolve bit for bit")
    fast_d = max(float((f - g).abs().max())
                 for f, g in zip(outs["fast"], outs["general"]))
    check(fast_d <= FAST_TOL, f"fast within {FAST_TOL} of general "
                              f"(max|d|={fast_d:.3g})")
    check(launches == n_cycles,
          f"K1 launched once per cycle ({launches} launches, {n_cycles} "
          "cycles)")
    for path in outs:
        med = statistics.median(times[path])
        print(f"  {path}: median cycle {med * 1e3:.3f} ms over {CYCLES} "
              f"({', '.join(f'{t * 1e3:.3f}' for t in times[path])} ms)",
              flush=True)
    print(f"  peak device memory {peak_gb:.3f} GB", flush=True)

    # -- 6. card against CPU -------------------------------------------------
    print("[card vs CPU, 256x256 cut]", flush=True)
    m = 256
    inside = ((plats >= lats[0, 0]) & (plats <= lats[m - 1, 0])
              & (plons >= lons[0, 0]) & (plons <= lons[0, m - 1]))
    sub_bg = background[:m, :m]
    sub = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        g2 = gt.Grid(lats[:m, :m], lons[:m, :m])
        pts2 = gt.Points(plats[inside], plons[inside],
                         np.zeros(inside.sum()), np.zeros(inside.sum()))
        pipe2 = gt.Pipeline(g2, pts2, gt.BarnesStructure(10000.0),
                            halfwidth=7, statistic=gt.Mean, max_points=10,
                            ratios=ratios[inside], device=d)
        po2 = (sub_bg.reshape(-1)[g2.nearest_map(pts2.lats, pts2.lons)]
               + noise[inside])
        sub[where] = {path: pipe2.run_device(
            torch.as_tensor(sub_bg, device=d), torch.as_tensor(po2, device=d),
            ratios[inside], path=path).cpu()
            for path in ("fast", "general", "resolve")}
    print(f"  {int(inside.sum())} obs in the cut", flush=True)
    for path in sub["cuda"]:
        d = float((sub["cuda"][path] - sub["cpu"][path]).abs().max())
        check(d <= CARD_CPU_TOL, f"{path}: card vs CPU max|d|={d:.3g}")

    print(json.dumps({"kernels": [{
        "name": "neighbourhood_mean",
        "route": "cuda",
        "source": "gridpp_tpu_torch/csrc/neighbourhood_mean.cu",
        "replaces": "gridpp_tpu/ops/pallas_stencil.py:301",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
