"""Benchmark of the port at bench.py's configuration: its measurements,
its definitions and its JSON line, on a torch device.

    python -m gridpp_tpu_torch.tools.bench [--n 2000] [--obs 10000]
        [--members 10] [--cycles 6] [--repeats 3] [--device cuda|cpu]

The problem is bench.py:57-69 (seed 0, the draws in its order): an n x n
grid over 55-62N 5-12E, `--obs` uniform stations, a normal(280, 5)
background, BarnesStructure(10 km), pobs the background at the stations
(nearest) plus normal(0, 1), ratios 0.1; the ensemble rows' `--members`
members of normal(280, 5), psigmas 1.5 and perturbed obs (bench.py:160-186).
The pipelines (Pipeline Mean h=7, EnsiPipeline, MultiEnsiPipeline ebesc,
ebe and utem; max_points=10) share one structure object, so the canonical
shortlist is built once.

Each of the seven paths (fast, general, general_resolve, ensi,
ensi_multi_ebesc, ensi_multi_ebe, ensi_multi_utem) is timed as bench.py
times it: one warm cycle, then `--cycles` chained cycles on device-resident
inputs distinct per cycle, up to a synchronised device, over the cycles
(compute_s; the sample is taken `--repeats` times and its median reported,
beside the spread (max - min) / median); the best of bench.py's number of
pageable downloads of distinct outputs (d2h_s). Around them: the device
bandwidth of `a + 1` on 4096² f32 (8 chained, best of 3), the best-of-reps
16 MB and 160 MB uploads (the host add of bench.py included), and for fast
(4 cycles) and ensi (3 cycles) a serial upload, compute and download loop
beside `serve_stream`, back to back on the same host cycles.

On a card the fast and general paths are captured CUDA graphs
(api/pipeline.py, ops/graph.py): the warm cycle runs eagerly and captures
the graph, the timed cycles replay it, and the general path's guard
branches on the device under a conditional graph node, so chained cycles
queue with no host wait between them. general_resolve and the ensemble
paths run eagerly.

Checks (any failure exits 1 and prints no JSON): the last `general` output
equals the last `general_resolve` output bit for bit; `fast` within 1e-3
of `general`; every output finite; the `serve_stream` analyses equal the
serial loop's bit for bit; on a card K1 launched once per cycle of the
three deterministic paths and of the fast serving loops (its wrapper's
counter, to which a graph replay adds the launches it makes; no launch on
the CPU).

Prints progress and each stage's seconds to stderr and one JSON line to
stdout: every key of bench.py's line with its meaning, unrounded, plus
`backend`, `device_name`, `device_power_limit_w` (nvidia-smi; null off
the card) and each path's `{key}_compute_spread`. With `--repeats 1` every
number keeps bench.py's definition. Runs on the card unless `--device cpu`
is given; no card and no `--device cpu` exits 2.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import gridpp_tpu_torch as gt
from gridpp_tpu_torch.ops import stencil

BASELINE = 12_490.0     # bench.py:227: the reference's combined gridpoints/s
METRIC = "oi2000sq_plus_neighbourhood_gridpoints_per_s"
CYCLES = 6              # bench.py:75
XFER_REPS = 4           # bench.py:76
FAST_TOL = 1e-3         # tests/test_pipeline_consistency.py:86
PATHS = ("fast", "general", "general_resolve", "ensi", "ensi_multi_ebesc",
         "ensi_multi_ebe", "ensi_multi_utem")
DETERMINISTIC = ("fast", "general", "general_resolve")
STREAMED = {"fast": 4, "ensi": 3}   # serving cycles, bench.py:218-225
PATH_SUFFIXES = ("compute_pts_per_s", "compute_vs_baseline",
                 "serving_pts_per_s", "d2h_s", "out_mb", "compute_spread")
STREAM_SUFFIXES = ("serving_serial_pts_per_s",
                   "serving_overlapped_pts_per_s")
TOP_KEYS = ("metric", "value", "unit", "vs_baseline", "headline_note",
            "device_bw_gbytes_s", "h2d_16mb_s", "h2d_160mb_s",
            "link_mb_per_s", "backend", "device_name",
            "device_power_limit_w")


class CheckFailed(RuntimeError):
    """A check of the run failed: no JSON line is printed."""


def stage(msg):
    """Progress to stderr (stdout carries the one JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def output_keys():
    """The keys of the JSON line, in order."""
    keys = list(TOP_KEYS)
    for key in PATHS:
        keys += [f"{key}_{f}" for f in PATH_SUFFIXES]
        if key in STREAMED:
            keys += [f"{key}_{f}" for f in STREAM_SUFFIXES]
    return keys


def min_time(fn, reps):
    """Best of reps host-clock seconds of fn() (bench.py:38-47)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def field_draws(rng, n, p):
    """bench.py:57-66's draws from rng, in its order: the grid's (lats,
    lons), the stations' plats and plons, the (n, n) background and the
    obs noise."""
    lats, lons = np.meshgrid(np.linspace(55, 62, n), np.linspace(5, 12, n),
                             indexing="ij")
    plats = rng.uniform(55, 62, p)
    plons = rng.uniform(5, 12, p)
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    noise = rng.normal(0, 1, p).astype(np.float32)
    return lats, lons, plats, plons, background, noise


def problem(n=2000, p=10000, members=10, seed=0):
    """bench.py's problem, every draw in its order (the upload shifts of
    bench.py:140-147 included, so the ensembles are its draws): a dict of
    grid, points, structure, background, pback, pobs, ratios, shifts and
    ens_shifts (the uploads' offsets), ens (the 160 MB upload's and the
    ensi serving cycles' members), bg_ens, psig and pobs_e."""
    rng = np.random.default_rng(seed)
    lats, lons, plats, plons, background, noise = field_draws(rng, n, p)
    grid = gt.Grid(lats, lons)
    points = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    pback = gt.nearest(grid, points, background)
    out = dict(grid=grid, points=points,
               structure=gt.BarnesStructure(10000.0),
               background=background, pback=pback, pobs=pback + noise,
               ratios=np.full(p, 0.1, np.float32))
    out["shifts"] = [np.float32(rng.integers(1 << 20))
                     for _ in range(XFER_REPS)]
    out["ens"] = rng.normal(280, 5, (n, n, members)).astype(np.float32)
    out["ens_shifts"] = [np.float32(rng.integers(1 << 20)) for _ in range(2)]
    out["bg_ens"] = rng.normal(280, 5, (n, n, members)).astype(np.float32)
    out["psig"] = np.full(p, 1.5, np.float32)
    out["pobs_e"] = (pback[:, None] + rng.normal(0, 1, (p, members))
                     ).astype(np.float32)
    return out


def card_identity(dev):
    """(device_name, device_power_limit_w): torch's name of the card and
    nvidia-smi's power limit in W; ("cpu", None) off the card."""
    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(dev)
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        stage(f"nvidia-smi: {line}")
        return name, float(line.rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return name, None


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    stage(f"ok: {what}")


def run(n=2000, p=10000, members=10, cycles=CYCLES, repeats=3,
        device="cuda"):
    """The whole benchmark on device; returns the JSON line's dict, or
    raises CheckFailed."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        stage(f"{what}: {now - clock[-1]:.3f} s")
        clock.append(now)

    t_all = clock[0]
    name, power = card_identity(dev)
    prob = problem(n, p, members)
    lap(f"problem {n}x{n}, {p} obs, {members} members (host draws, "
        "nearest)")
    bgs = [on_dev(prob["background"] + np.float32(i)) for i in range(cycles)]
    obs = [on_dev(prob["pobs"] + np.float32(i)) for i in range(cycles)]
    bg_ens = on_dev(prob["bg_ens"])
    psig = on_dev(prob["psig"])
    pobs_e = on_dev(prob["pobs_e"])
    prat = on_dev(prob["ratios"])
    sync()
    lap("device-resident inputs")

    grid, points, structure = prob["grid"], prob["points"], prob["structure"]

    def build(label, make):
        t0 = time.perf_counter()
        pipe = make()
        sync()
        stage(f"set-up {label}: {time.perf_counter() - t0:.3f} s")
        return pipe

    pipe = build("Pipeline (shortlist, tile tables, static weights)",
                 lambda: gt.Pipeline(grid, points, structure, halfwidth=7,
                                     statistic=gt.Mean, max_points=10,
                                     ratios=prob["ratios"], device=dev))
    epipe = build("EnsiPipeline", lambda: gt.EnsiPipeline(
        grid, points, structure, max_points=10, device=dev))
    mpipes = {v: build(f"MultiEnsiPipeline {v}", lambda v=v: gt.
                       MultiEnsiPipeline(grid, points, structure, variant=v,
                                         max_points=10, device=dev))
              for v in ("ebesc", "ebe", "utem")}
    lap("set-ups")

    k1 = stencil.neighbourhood_mean_cuda
    k1_total = 0

    def k1_check(label, n_cycles):
        nonlocal k1_total
        want = n_cycles if cuda else 0
        check(k1.launches == want,
              f"{label}: K1 launched {k1.launches} times, {want} wanted "
              f"({n_cycles} cycles{'' if cuda else '; no kernel on the CPU'}"
              ")")
        k1_total += k1.launches

    # device health: a + 1 on 64 MB, 8 chained, best of 3 (bench.py:123-134)
    xcal = torch.ones((4096, 4096), dtype=torch.float32, device=dev)
    xcal + 1.0
    sync()
    bw = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        cur = xcal
        for _ in range(8):
            cur = cur + 1.0
        sync()
        bw = max(bw, 2 * xcal.numel() * 4 * 8 / (time.perf_counter() - t0)
                 / 1e9)
    del xcal, cur
    lap(f"device bandwidth {bw:.1f} GB/s")

    # uploads, best of reps, the host add included (bench.py:136-147)
    def upload(host, shifts):
        it = iter(shifts)

        def one():
            on_dev(host + next(it))
            sync()
        return min_time(one, len(shifts))

    h2d = upload(prob["background"], prob["shifts"])
    h2d_ens = upload(prob["ens"], prob["ens_shifts"])
    lap(f"uploads: 16 MB {h2d:.6f} s, 160 MB {h2d_ens:.6f} s")

    results, last = {}, {}

    def bench_path(key, run_one):
        """Compute-only cycle time (median of repeats) and the download of
        one output (bench.py:92-117)."""
        k1.launches = 0
        out = run_one(0)
        sync()
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            outs = [run_one(i) for i in range(cycles)]
            sync()
            samples.append((time.perf_counter() - t0) / cycles)
        dt = statistics.median(samples)
        if key in DETERMINISTIC:
            k1_check(key, 1 + repeats * cycles)
        nbytes = out.numel() * out.element_size()
        reps = min(2 if nbytes > 100e6 else XFER_REPS, cycles)
        d2h = min_time(lambda it=iter(outs): next(it).cpu().numpy(), reps)
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{key}: all {len(outs)} outputs finite, shape "
              f"{tuple(out.shape)}")
        results[key] = {
            "compute_s": dt, "compute_pts_per_s": n * n / dt,
            "compute_spread": (max(samples) - min(samples)) / dt,
            "d2h_s": d2h, "out_mb": nbytes / 1e6}
        last[key] = outs[-1]
        lap(f"{key}: compute {dt * 1e3:.3f} ms a cycle (samples "
            f"{', '.join(f'{s * 1e3:.3f}' for s in samples)} ms), d2h "
            f"{d2h * 1e3:.3f} ms, {nbytes / 1e6:.1f} MB")

    bench_path("fast", lambda i: pipe.run_device(bgs[i], obs[i],
                                                 assume_valid=True))
    bench_path("general", lambda i: pipe.run_device(bgs[i], obs[i],
                                                    path="general"))
    bench_path("general_resolve", lambda i: pipe.run_device(
        bgs[i], obs[i], path="resolve"))
    bench_path("ensi", lambda i: epipe.run_device(
        bg_ens, obs[i], psig, assume_valid=True)[0])
    bench_path("ensi_multi_ebesc", lambda i: mpipes["ebesc"].run_device(
        bg_ens, pobs_e + np.float32(i * 0.01), prat)[0])
    bench_path("ensi_multi_ebe", lambda i: mpipes["ebe"].run_device(
        bg_ens, pobs_e + np.float32(i * 0.01), prat,
        background_corr=bg_ens)[0])
    bench_path("ensi_multi_utem", lambda i: mpipes["utem"].run_device(
        bg_ens, obs[i], prat, background_corr=bg_ens)[0])

    check(torch.equal(last["general"], last["general_resolve"]),
          "general == general_resolve bit for bit (last cycle)")
    d = float((last["fast"] - last["general"]).abs().max())
    check(d <= FAST_TOL, f"fast within {FAST_TOL} of general "
                         f"(max|d|={d:.3g})")
    del last

    # serving: a serial upload -> compute -> download loop, then
    # serve_stream, back to back on the same host cycles (bench.py:188-225)
    def stream_rates(key, pipe_obj, run_serial, make_cycle, n_cycles):
        cyc = [make_cycle(i) for i in range(n_cycles)]
        k1.launches = 0
        next(iter(pipe_obj.serve_stream([cyc[0]])))
        t0 = time.perf_counter()
        serial = [run_serial(*[on_dev(np.asarray(a, np.float32))
                               for a in args]).cpu().numpy()
                  for args in cyc]
        serial_dt = (time.perf_counter() - t0) / n_cycles
        t0 = time.perf_counter()
        streamed = list(pipe_obj.serve_stream(cyc))
        dt = (time.perf_counter() - t0) / n_cycles
        if key == "fast":
            k1_check("fast serving", 1 + 2 * n_cycles)
        check(len(streamed) == n_cycles
              and all(np.array_equal(a, b) for a, b in zip(streamed, serial))
              and all(np.isfinite(a).all() for a in streamed),
              f"{key}: serve_stream's {n_cycles} analyses equal the serial "
              "loop's bit for bit, finite")
        r = results[key]
        r["serving_serial_pts_per_s"] = n * n / serial_dt
        r["serving_overlapped_pts_per_s"] = n * n / dt
        lap(f"{key} serving: serial {serial_dt * 1e3:.3f} ms a cycle, "
            f"serve_stream {dt * 1e3:.3f} ms")

    background, pobs = prob["background"], prob["pobs"]
    stream_rates("fast", pipe,
                 lambda bg, po: pipe.run_device(bg, po, assume_valid=True),
                 lambda i: (background + np.float32(i), pobs),
                 STREAMED["fast"])
    stream_rates("ensi", epipe,
                 lambda bg, po, ps: epipe.run_device(
                     bg, po, ps, assume_valid=True)[0],
                 lambda i: (prob["ens"] + np.float32(i), pobs,
                            np.full(p, 1.5, np.float32)), STREAMED["ensi"])
    stage(f"K1 launches in all: {k1_total}")

    uploads = {key: h2d if key in DETERMINISTIC else h2d_ens
               for key in PATHS}
    value = results["general"]["compute_pts_per_s"]
    out = {"metric": METRIC, "value": value, "unit": "gridpoints/s",
           "vs_baseline": value / BASELINE,
           "headline_note": "device-resident compute, general path",
           "device_bw_gbytes_s": bw, "h2d_16mb_s": h2d,
           "h2d_160mb_s": h2d_ens,
           "link_mb_per_s": 16.0 / max(h2d, 1e-9),
           "backend": dev.type, "device_name": name,
           "device_power_limit_w": power}
    for key in PATHS:
        r = results[key]
        out[f"{key}_compute_pts_per_s"] = r["compute_pts_per_s"]
        out[f"{key}_compute_vs_baseline"] = r["compute_pts_per_s"] / BASELINE
        out[f"{key}_serving_pts_per_s"] = n * n / (
            uploads[key] + r["compute_s"] + r["d2h_s"])
        out[f"{key}_d2h_s"] = r["d2h_s"]
        out[f"{key}_out_mb"] = r["out_mb"]
        out[f"{key}_compute_spread"] = r["compute_spread"]
        for f in STREAM_SUFFIXES:
            if f in r:
                out[f"{key}_{f}"] = r[f]
    stage(f"the whole run: {time.perf_counter() - t_all:.3f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2000, help="grid side")
    ap.add_argument("--obs", type=int, default=10000, help="stations")
    ap.add_argument("--members", type=int, default=10,
                    help="ensemble members")
    ap.add_argument("--cycles", type=int, default=CYCLES,
                    help="chained cycles a compute sample")
    ap.add_argument("--repeats", type=int, default=3,
                    help="compute samples; their median is reported")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("bench: no CUDA card (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda":
        # the EnSI transform's products run in full f32 (ops.oi_ensi._mm)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        out = run(args.n, args.obs, args.members, args.cycles, args.repeats,
                  args.device)
    except CheckFailed as e:
        print(f"bench: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
