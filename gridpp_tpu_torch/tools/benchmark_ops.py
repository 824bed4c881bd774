"""Per-operator table of gridpp_tpu_torch's numpy API at gridpp's benchmark
sizes (the rows, names, details and sizes of gridpp's own expected-runtime
table, tests/benchmark.py in both repositories).

Each row runs on two routes:
- the host route, the top-level function (numpy in and out on the CPU);
- the card route, where the row's function has one: its module function
  gridpp_tpu_torch.api.<module>.<name> called unpinned, with torch's
  default device untouched, which runs it on the card (numpy in and out,
  the copies included).

A route's time is the median of -n calls after one warm-up call; a host
route whose warm-up call takes over 10 s is timed by that one call, and
the table says so. Where both routes ran, the card's result is held to
the host's at the function's bar (PERF.md section 2) and the largest
difference is printed. A row that raises fails the run. The reference's
expected seconds (gridpp C++ on an Intel i7 at 3.40 GHz, one OpenMP
thread) stand beside each row. The last line is a JSON object of the rows.

    python -m gridpp_tpu_torch.tools.benchmark_ops [-s 1] [-n 3]
        [-t neighbourhood oi ...] [--device cuda|cpu]

--device cpu times the host route alone.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch

SLOW_HOST_S = 10.0
K1_BAR = (1e-5, 1e-4)           # tests/test_pallas_stencil.py:36-38
DOWN_BAR = (1e-6, 1e-4)         # bilinear, gradients, curves (phase 10)
SLICE_BAR = (1e-5, 1e-5)        # search, window, masking, diagnostics
QF_BAR = (1e-5, 1e-5)           # tests/test_torch_cuda.py: quantile_fast
OI_BAR = (0.0, 1e-2)            # tests/test_parity_dense.py:10
LDC_BAR = (2e-5, 2e-5)


def build_grid(gt, n, scaling=1.0, lat0=50.0, lon0=5.0, dlat=5.0):
    n = int(n * scaling)
    lats, lons = np.meshgrid(np.linspace(lat0, lat0 + dlat, n),
                             np.linspace(lon0, lon0 + dlat, n),
                             indexing="ij")
    return gt.Grid(lats, lons, np.zeros((n, n)), np.zeros((n, n)))


def build_points(gt, num, scaling=1.0, lat0=50.0, lon0=5.0, dlat=5.0,
                 seed=0):
    num = int(num * scaling)
    rng = np.random.default_rng(seed)
    return gt.Points(rng.uniform(lat0, lat0 + dlat, num),
                     rng.uniform(lon0, lon0 + dlat, num),
                     np.zeros(num), np.zeros(num))


def rows(gt, s):
    """(name, detail) -> {"expected": s or None, "make_args": thunk, "func":
    the host route, "bar": the card route's bar (None: equal)}, in the
    reference table's order, at scaling s."""
    rng = np.random.default_rng(1000)
    radius = 7
    quantile = 0.5
    thresholds = np.linspace(0, 1, 11)
    structure = gt.BarnesStructure(10000)

    # Inputs are made lazily, so skipped rows cost nothing.
    def I(*shape):
        return rng.random([int(shape[0] * s)] + list(shape[1:]), np.float32)

    def grid(n):
        return build_grid(gt, n, s)

    def points(num):
        return build_points(gt, num, s)

    run = collections.OrderedDict()

    def add(name, detail, expected, make_args, func=None, bar=None):
        run[(name, detail)] = {"expected": expected,
                               "make_args": make_args,
                               "func": func or getattr(gt, name),
                               "bar": bar}

    add("Grid", "1000²", 0.74,
        lambda: (np.meshgrid(np.linspace(50, 55, int(1000 * s)),
                             np.linspace(5, 10, int(1000 * s)),
                             indexing="ij")),
        func=lambda la, lo: gt.Grid(la, lo))
    add("neighbourhood", "10000² mean", 2.05,
        lambda: (np.zeros([int(10000 * s), int(10000 * s)], np.float32),
                 radius, gt.Mean), bar=K1_BAR)
    add("neighbourhood", "2000² max", 0.99,
        lambda: (I(2000, int(2000 * s)), radius, gt.Max))
    add("neighbourhood_quantile_fast", "2000²", 1.23,
        lambda: (I(2000, int(2000 * s)), quantile, radius, thresholds),
        bar=QF_BAR)
    add("neighbourhood_quantile", "500²", 1.70,
        lambda: (I(500, int(500 * s)), quantile, radius))
    add("bilinear", "1000²", 1.68,
        lambda: (grid(1000), grid(1000), I(1000, int(1000 * s))),
        bar=DOWN_BAR)
    add("bilinear", "1000² x 50", 4.42,
        lambda: (grid(1000), grid(1000),
                 I(50, int(1000 * s), int(1000 * s))), bar=DOWN_BAR)
    add("nearest", "1000²", 1.52,
        lambda: (grid(1000), grid(1000), I(1000, int(1000 * s))))
    add("nearest", "1000² x 50", 1.93,
        lambda: (grid(1000), grid(1000),
                 I(50, int(1000 * s), int(1000 * s))))
    add("gridding", "200² 100000", 0.61,
        lambda: (grid(200), points(100000),
                 np.zeros(int(100000 * s), np.float32), 5000, 1, gt.Mean))
    add("gridding_nearest", "200² 100000", 0.11,
        lambda: (grid(200), points(100000),
                 np.zeros(int(100000 * s), np.float32), 1, gt.Mean))
    add("optimal_interpolation", "100² 1000", 0.80,
        lambda: (grid(100), I(100, int(100 * s)), points(1000),
                 np.zeros(int(1000 * s)), np.ones(int(1000 * s)),
                 np.ones(int(1000 * s)), structure, 20), bar=OI_BAR)

    def spatial_structure():
        n = int(100 * s)
        lats, lons = np.meshgrid(np.linspace(50, 55, n),
                                 np.linspace(5, 10, n), indexing="ij")
        sgrid = gt.Grid(lats, lons)
        h = np.full((n, n), 10000.0, np.float32)
        v = np.full((n, n), 200.0, np.float32)
        return gt.BarnesStructure(sgrid, h, v, np.zeros((n, n)))

    add("optimal_interpolation", "100² 1000 spatial-h", 0.91,
        lambda: (grid(100), I(100, int(100 * s)), points(1000),
                 np.zeros(int(1000 * s)), np.ones(int(1000 * s)),
                 np.ones(int(1000 * s)), spatial_structure(), 20),
        bar=OI_BAR)
    add("optimal_interpolation", "2000² 10000", None,
        lambda: (grid(2000), I(2000, int(2000 * s)), points(10000),
                 np.zeros(int(10000 * s)), np.ones(int(10000 * s)),
                 np.ones(int(10000 * s)), structure, 10), bar=OI_BAR)
    add("dewpoint", "1e7", 0.53,
        lambda: (np.zeros(int(1e7 * s), np.float32) + 273.15,
                 np.zeros(int(1e7 * s), np.float32)), bar=SLICE_BAR)
    add("fill", "1e5", 1.96,
        lambda: (grid(200), np.zeros([int(200 * s), int(200 * s)],
                                     np.float32),
                 points(100000), np.ones(int(100000 * s)) * 5000, 1, False))
    add("doping_square", "1e5", 0.12,
        lambda: (grid(200), np.zeros([int(200 * s), int(200 * s)],
                                     np.float32),
                 points(100000), np.ones(int(100000 * s)),
                 np.ones(int(100000 * s), "int") * 5, False))
    add("doping_circle", "1e5", 2.00,
        lambda: (grid(200), np.zeros([int(200 * s), int(200 * s)],
                                     np.float32),
                 points(100000), np.ones(int(100000 * s)),
                 np.ones(int(100000 * s)) * 5000, False))
    add("local_distribution_correction", "200² 1000", 1.31,
        lambda: (grid(200), np.zeros([int(200 * s), int(200 * s)],
                                     np.float32),
                 points(1000), np.ones(int(1000 * s)),
                 np.ones(int(1000 * s)), structure, 0.1, 0.9, 5),
        bar=LDC_BAR)
    add("full_gradient", "1000²", 1.59,
        lambda: (grid(1000), grid(1000), I(1000, int(1000 * s)),
                 I(1000, int(1000 * s)), I(1000, int(1000 * s))),
        bar=DOWN_BAR)
    add("calc_gradient", "2000²", 0.45,
        lambda: (rng.random([int(2000 * s), int(2000 * s)],
                            np.float32) * 100,
                 np.zeros([int(2000 * s), int(2000 * s)], np.float32),
                 gt.LinearRegression, 10, 0, 100, 0), bar=DOWN_BAR)
    add("mask_threshold_downscale_consensus", "100²→1000²", 0.91,
        lambda: (grid(100), grid(1000), I(100, int(100 * s), 10),
                 I(100, int(100 * s), 10), I(100, int(100 * s), 10),
                 rng.random([int(1000 * s), int(1000 * s)], np.float32),
                 gt.Lt, gt.Mean), bar=SLICE_BAR)
    add("neighbourhood_search", "2000² 7x7", 1.11,
        lambda: (I(2000, int(2000 * s)), I(2000, int(2000 * s)),
                 3, 0.7, 1.0, 0.1,
                 rng.random([int(2000 * s), int(2000 * s)]) < 0.5),
        bar=SLICE_BAR)
    add("window", "100000x1000", 1.67,
        lambda: (I(100000, 1000), 101, gt.Mean, False, False),
        bar=SLICE_BAR)
    add("gamma_inv", "5*201*476", 1.168,
        lambda: (rng.random(int(5 * 201 * 476 * s)) * 0.9 + 0.05,
                 rng.random(int(5 * 201 * 476 * s)) + 0.5,
                 rng.random(int(5 * 201 * 476 * s)) + 0.5))
    add("apply_curve", "2000²", 0.06,
        lambda: (I(2000, int(2000 * s)), np.sort(rng.random(2000)),
                 np.sort(rng.random(2000)), gt.OneToOne, gt.OneToOne),
        bar=DOWN_BAR)
    add("apply_curve", "2000² gridded curves", 0.87,
        lambda: (I(2000, int(2000 * s)),
                 np.sort(rng.random([int(2000 * s), int(2000 * s), 5],
                                    np.float32), axis=-1),
                 np.sort(rng.random([int(2000 * s), int(2000 * s), 5],
                                    np.float32), axis=-1),
                 gt.OneToOne, gt.OneToOne), bar=DOWN_BAR)
    add("get_optimal_threshold", "1e6", 0.38,
        lambda: (rng.standard_normal(int(1e6 * s)).astype(np.float32),
                 rng.standard_normal(int(1e6 * s)).astype(np.float32),
                 0.0, gt.Ets))
    return run


def max_diff(got, want, bar):
    """(within the bar, largest difference) of the card's result against
    the host's: NaN in the same places, equal (bar None) or within (rtol,
    atol) elsewhere."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return False, float("inf")
    same_nan = np.array_equal(np.isnan(got), np.isnan(want))
    d = np.abs(np.nan_to_num(got.astype(np.float64))
               - np.nan_to_num(want.astype(np.float64)))
    err = float(d.max()) if d.size else 0.0
    if bar is None:
        ok = err == 0.0
    else:
        ok = bool(np.allclose(got, want, rtol=bar[0], atol=bar[1],
                              equal_nan=True))
    return same_nan and ok, err


def _time(fn, args, iterations, slow=None):
    """(seconds, calls timed, result): one warm-up call, then the median of
    `iterations` calls; the warm-up alone when it took over `slow`
    seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    warm = time.perf_counter() - t0
    if slow is not None and warm > slow:
        return warm, 1, out
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), iterations, out


def run(scaling=1.0, iterations=3, functions=None, device="cuda",
        log=print):
    """Time every row (those whose label contains one of `functions`, when
    given) on the host route and, with device "cuda", on the card route.
    Returns the rows' results; raises on a row that raises."""
    import gridpp_tpu_torch as gt
    from .smoke import device_routes

    card = torch.device(device).type == "cuda"
    routes = {key.split(".", 1)[1]: fn for key, fn in device_routes().items()}
    where = (torch.cuda.get_device_name(0) if card
             else "the host only (no card route)")
    log(f"gridpp_tpu_torch benchmark (version {gt.version()}): host route "
        f"(top level, CPU) and card route ({where})")
    log("Reference expected times: gridpp C++ on an Intel i7 3.40 GHz, "
        "1 OpenMP thread")
    log("Execution model: numpy in and out; a time is the median of "
        f"{iterations} calls after a warm-up call (host calls over "
        f"{SLOW_HOST_S:.0f} s: the one call, marked *)")
    log("-" * 100)
    log("%-44s %8s %11s %11s %10s %12s" % (
        "Function", "Ref(s)", "host(s)", "card(s)", "host/card",
        "max|card-host|"))
    results = []
    for (name, detail), spec in rows(gt, scaling).items():
        label = f"{name} {detail}"
        if functions and not any(t in label for t in functions):
            continue
        args = spec["make_args"]()
        host_s, host_n, host_out = _time(spec["func"], args, iterations,
                                         slow=SLOW_HOST_S)
        row = {"name": label, "expected_s": spec["expected"],
               "host_s": host_s, "host_calls": host_n, "card_s": None,
               "max_abs_diff": None, "bar": None, "within_bar": None}
        fn = routes.get(name) if spec["func"] is getattr(gt, name, None) \
            else None
        if card and fn is not None:
            row["card_s"], _, card_out = _time(fn, args, iterations)
            row["within_bar"], row["max_abs_diff"] = max_diff(
                card_out, host_out, spec["bar"])
            row["bar"] = "equal" if spec["bar"] is None else list(
                spec["bar"])
        results.append(row)
        exp = spec["expected"]
        ratio = (f"{host_s / row['card_s']:9.1f}x" if row["card_s"]
                 else f"{'-':>10}")
        diff = ("-" if row["max_abs_diff"] is None else
                f"{row['max_abs_diff']:.3g}"
                + ("" if row["within_bar"] else " FAIL"))
        log("%-44s %8s %10.4f%s %11s %s %12s" % (
            label, f"{exp:.2f}" if exp else "-", host_s,
            "*" if host_n == 1 and iterations > 1 else " ",
            "-" if row["card_s"] is None else f"{row['card_s']:.4f}",
            ratio, diff), flush=True)
    log("-" * 100)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", type=float, default=1.0, dest="scaling",
                    help="scale problem sizes by this factor")
    ap.add_argument("-n", type=int, default=3, dest="iterations",
                    help="iterations to take the median over")
    ap.add_argument("-t", dest="functions", nargs="*",
                    help="run only rows whose label contains any of these "
                         "substrings")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: host and card routes) or cpu "
                         "(the host route alone)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("benchmark_ops: no CUDA card (pass --device cpu for the host "
              "route alone)", file=sys.stderr)
        return 2
    results = run(args.scaling, args.iterations, args.functions,
                  args.device)
    bad = [r["name"] for r in results if r["within_bar"] is False]
    if bad:
        print(f"card route past its bar: {', '.join(bad)}")
    print(json.dumps({"benchmarks": results}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
