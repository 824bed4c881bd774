"""Smoke run of gridpp_tpu_torch's serving, neighbourhood-statistics, OI
API, downscaling/calibration paths, the rest of gridpp's numpy API, the
parallel layer, the command-line client, the port's tools, its roofline
and its bench on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. In order it:
1. requires a CUDA card (there is no CPU path) and prints its name and
   power limit; TF32 is switched off for matmul and cuDNN;
2. builds the kernels K1-K5, their wide route and the general graph's
   conditional node (csrc/*.cu, one nvcc per source, all started
   together) and the native host library, and prints the build times and
   the compiler's resource report;
3. holds every kernel against its plain PyTorch version on the card, on
   K1's cases (2000 x 2000 with 0% and 10% NaN, small edge shapes, a
   batched (3, 256, 300), EnSI's ten 2000 x 2000 member planes with 0% and
   10% NaN, and the strip edges of K1/K2/K3: 1-row and 1-column fields, X
   not a multiple of 4 or 128, hx above the register cap (9, 32), the
   largest halfwidth at which K2 stays fused (60), a NaN-free field with a
   few NaN): K1
   (Mean/Sum/Count) rtol 1e-5, atol 1e-4; K2 (Min/Max) equality; K3
   (Std/Variance) rtol 2e-5, atol 2e-3; K4 (quantile_fast, which has only
   the wide route) bit for bit, NaN positions included, at q in {0, 0.25,
   0.5, 0.9, 1}, at h=7 and h=8 (either side of the 8/16-bit lane width of
   its window counts) and h=88 with T in {1, 4, 5, 11, 12, 33} (unsorted at
   12), on exact cdf ties at h in {1, 7, 8}, all NaN for a NaN q; K5
   (members) at E in {1, 3, 10, 25} on (130, 257, E) (X * E not a
   multiple of 4), at 2000 x 2000 x 10 with 10% NaN and on a NaN-free
   normal(280, 5) ensemble: rtol 1e-5, atol 1e-4 for Mean/Sum/Count and
   equality for Min/Max, against its plain version and against K1/K2 on
   the first and last member. Then the wide route
   (ops/stencil.py::stencil_plan picks it past each kernel's crossover):
   K1-K3 at h in {81, 100, 300} on
   the 2000 x 2000 normal(280, 5) field with 10% NaN (its anomaly for K3),
   K4 bit for bit at h in {8, 120, 300} (361,201 cells a window at 300)
   with T in {1, 11, 33} on a 2000 x 2000 field with 10%
   NaN and an all-NaN region, and on exact cdf ties, K5 at h=150 on
   2000 x 2000 x 10, each call counted on the wrapper's wide counter;
4. times each kernel, its plain version and, where one PyTorch call
   computes the same function (NaN-free input), that call, by CUDA events
   at full width, and the kernel's device time alone from torch.profiler:
   K1/K2/K3 at 2000 x 2000, h=7 (F.avg_pool2d / F.max_pool2d for K1/K2),
   and K3 on EnSI's ten member planes;
   K4 on a uniform [0, 1) 2000 x 2000 field, h=7, q=0.5, thresholds
   linspace(0, 1, 11) (tests/benchmark.py:65-67, 94-95); K5 Mean on the
   2000 x 2000 x 10 normal(280, 5) ensemble (F.avg_pool2d on its
   channels-last (1, E, Y, X) view), beside 10 launches of K1 on its
   contiguous member planes and beside K5 on the 10%-NaN field; prints
   each kernel's time cold (gridpp_tpu_torch.tools.roofline.cold_ms:
   launches rotated over copies of the input past 256 MB) and its bound
   (gridpp_tpu_torch.tools.roofline.count's bytes and operations over the
   card's published peaks, whichever takes longer); then
   each kernel at h=100 and h=300 by the route its plan picks (the wide
   route; K4's only one), beside its bound, its plain version and, at
   h=100, F.avg_pool2d / F.max_pool2d for K1/K2, with the device time of
   each of K4's two passes;
5. the serving path: builds Pipeline at the benchmark configuration
   (2000 x 2000 grid, 10,000 obs, BarnesStructure(10 km), max_points=10,
   neighbourhood Mean h=7, ratios 0.1, seed 0) on the card, runs cycles of
   the fast, general and resolve paths on distinct inputs plus one cycle
   with a third of the obs missing, and checks: finite output, general ==
   resolve bit for bit, fast within 1e-3 of general, one K1 launch per
   cycle (fast and general are captured graphs after their first call: a
   replay adds its launches to the counts) and one launch of the
   conditional's setter per general replay; prints each path's median
   cycle time. Then the captured cycles on that Pipeline, after
   load_state resets its guard: the 8-cycle validity/ratios sequence
   through the general graph (general == resolve bit for bit each cycle,
   rebuilds on cycles 0, 3, 5, 7 by the `rebuilds` counter, every returned
   analysis unchanged by later cycles, K1 once a cycle); general replays
   (pratios None, numpy unlike the static ratios, a tensor) and fast ones
   under set_sync_debug_mode("error"); serve_stream on the general path
   against a loop of __call__ bit for bit; 3 warm graphed general and fast
   cycles under torch.profiler (host and device ms, idle share, kernels a
   replay, K1 once a replay); the conditional node alone on 50 flags
   against the host's branch, timed. Then the same cycles with Mean
   h=100, each cycle's K1 call through the wide route;
6. the neighbourhood-statistics path, with every launch count set to 0
   before it and read after: the same Pipeline smoothed with Max h=7
   (checks as in 5, one K2 launch per cycle), then with Std h=7 on the
   field's anomaly (one K3 launch per cycle), then ops.neighbourhood Std
   (K3), ops.neighbourhood_quantile_fast (K4) at h=7 and at h=100 and
   ops.stencil.neighbourhood_members (K5) at full width;
   each kernel must have launched;
7. ensemble OI at the benchmark's ensemble rows (bench.py:160-186): one
   BarnesStructure(10 km) shared by every ensemble pipeline (the canonical
   shortlist is built once), a 2000 x 2000 x 10 normal(280, 5) ensemble,
   distinct per cycle, psigmas 1.5. EnsiPipeline at halfwidth 0 and with
   Mean h=7: 5 all-valid (fast) cycles and 5 general cycles on the same
   inputs, equal bit for bit, then a general cycle with a third of the obs
   missing; finite outputs, no condition failures, exactly one K5 launch
   per smoothed cycle and one launch of the EnSI kernel
   (csrc/ensi_transform.cu, `ensi_update_cuda.launches`) per block of
   rows, 4 a cycle at the default block of 2^20. Then EnsiPipeline
   smoothed with Std h=7 (obs of its
   smoothed members' mean): 3 cycles, finite, no condition failures,
   exactly one K3 launch on the (E, Y, X) member planes per cycle. Then
   MultiEnsiPipeline ebesc, ebe and utem, 5
   cycles each: finite outputs, no utem condition failures. Prints each
   pipeline's set-up time, the median cycle times and the phase's peak
   device memory;
8. runs a 256 x 256 cut of the same problem on the card and on the CPU
   (plain versions): Pipeline smoothed with Mean, Max and Std (max|d| <=
   1e-3), EnsiPipeline at h=0 and with Mean h=7 and MultiEnsiPipeline utem
   (max|d| <= 2e-3), ebe and ebesc (max|d| <= 1e-3);
9. gridpp's OI numpy API through its device route (the api modules'
   functions called under the card as torch's default device), on phase
   7's grid, obs and structure objects, so the cached canonical shortlist
   is shared: optimal_interpolation with every obs valid and with ~1%
   missing takes the shortlist route (the dense sweep is counted and must
   not run), is finite and within 1e-2 of Pipeline(halfwidth=0) `resolve`
   at every cell (tests/test_parity_dense.py:10); optimal_interpolation_
   full's analysis variance is finite and at most bvariance + 1e-5; with
   the obs of a 1 x 1 degree box dropped, truncated shortlist rows starve
   and the dense all-obs sweep runs (timed): on the rows not starved at
   least 99.9% of the cells lie within 1e-2 of `resolve`;
   optimal_interpolation_ensi on the 2000 x 2000 x 10 ensemble against
   EnsiPipeline(halfwidth=0) and ebesc, ebe and utem against
   MultiEnsiPipeline, max|d| < 1e-2 (tests/test_parity_dense.py:65, :101).
   Prints the median of 3 numpy calls of each function (wall clock, host
   preparation and transfers included) with its device sweep's share,
   beside the matching pipeline cycle, and the phase's peak device memory.
   On the 256 x 256 cut, each of the six functions through the card's
   device route, on the shortlist and with two thirds of the obs dropped
   (the starved fallback), against the port's top-level host-pinned
   function (the native C++ solvers on the CPU): max|d| < 1e-2, with the
   share of cells within 2e-4 printed;
10. gridpp's downscale -> gradient-correct -> calibrate path through the
   device route (the api modules' functions under the card), with every
   launch count set to 0 before its driving calls: the MEPS 2.5 km grid's
   published size, 949 x 739, over 55-62N 5-12E with seeded 0-2000 m
   relief, its land-area fraction and 24 leads of normal(280, 5)
   temperature, to phase 5's 2000 x 2000 grid (the same relief with finer
   detail) and its 10,000 stations. nearest and bilinear Grid -> Grid (3-D)
   and Grid -> Points; calc_gradient LinearRegression (h=10; exactly five
   K1 launches, and no other kernel in the phase) and MinMax (h=3) of
   temperature against elevation; full_gradient with the LR gradient and a
   laf gradient field, bilinear, all 24 leads; simple_gradient; apply_curve
   on the 2000 x 2000 output with a shared 101-knot quantile-mapping curve
   and with per-cell (2000, 2000, 11) curves. Each held against the port's
   host route (the top-level function): nearest equal, the others rtol
   1e-6, atol 1e-4; LR's five K1 fields against K1's plain version and its
   gradient against the plain route on the host at K1's bars, with its max
   difference to the native route and the cells whose decision (gradient
   or default) differs from it printed, with and without min_range. Prints
   the host map builds, the phase's peak device memory and each call's
   median time of 3 (numpy in and out) beside its device time (kernels and
   copies apart) and the host route's.
11. the rest of gridpp's numpy API through the device route (the api
   modules' functions under the card), with every launch count set to 0
   before its driving calls, on phase 5's domain at full size (2000 x 2000
   with phase 10's relief and its land-area fraction, the 10,000
   stations, seed 11): neighbourhood_score (a gamma precipitation forecast,
   60% dry, against the stations' obs, threshold 1 mm, Ets) at h=7 and
   h=25, exactly one K1 launch on its four indicator planes a call and no
   other kernel in the phase; neighbourhood_search of temperature with the
   land-area fraction as the search array, h=7, targets [0.8, 1.0], delta
   0.1 (its bands printed); local_distribution_correction of the
   precipitation against the stations' 24 (obs, forecast) pairs,
   BarnesStructure(10 km), quantiles 0.1-0.9, min_points 5 (K, K x T and
   the block printed); window on the 4M gridpoints as cases x 24 leads
   (Sum of 3 trailing, Mean of 5 centred, Max of 5 on the stacked route);
   downscale_probability and mask_threshold_downscale_consensus (Mean) of
   a MEPS 949 x 739 x 10-member ensemble to the 2000 x 2000 grid; the
   eight elementwise diagnostics on 2000 x 2000 fields; smart of MEPS
   temperature onto its own grid, num=5, BarnesStructure(5 km); and
   staticcorr_points of the stations against 1,000 knots, max_points 20,
   BarnesStructure(25 km). Each call's peak device memory; each held
   against the port's host route (the top-level function) on a 256 x 256
   cut: equal (window Max, downscale_probability), K1's bars
   (neighbourhood_score), rtol 1e-5 and atol 1e-5 (1e-2 Pa for the
   pressures), LDC past rtol/atol 2e-5 of its device route on the CPU on
   no more cells than that route parts from the native one, and of the
   native route on at most twice as many (ROADMAP F11); smart's selection
   margins printed where card and host part at full size; K1 on the (4,
   2000, 2000)
   planes against its plain version and avg_pool2d, timed, with its
   bound; each call's median time of 3 beside its device time and the
   host route's at full size (their difference printed); the host-only
   calls (gridding, gridding_nearest, count, distance, fill, fill_missing,
   doping_square, doping_circle, gamma_inv) timed once.
12. the parallel layer (gridpp_tpu_torch.parallel) at phase 5's size
   (2000 x 2000, 10,000 stations, BarnesStructure(10 km), max_points 10,
   Mean h=7), launch counts set to 0 before each driving run: (a) a
   one-rank NCCL group (initialize(), an all_reduce, global_mesh()):
   make_distributed_step three times, K1 once a step, equal to the
   whole-grid ops.neighbourhood + oi_dense_sweep at rtol 2e-5, atol 2e-4
   (tests/test_distributed.py:80), K1 on the 2014 x 2014 padded tile
   against its plain version; (b) four gloo ranks spawned on this card (a
   (2, 2) mesh, strips staged through host buffers): three steps each, K1
   once a step on every rank, the gathered analysis equal to (a)'s at the
   same bar; (c) sharded_neighbourhood Mean, Max and Std (on the anomaly)
   h=7 on (b)'s mesh against the whole grid at K1's bars, equal and K3's
   bars, one launch of each kernel a rank; each step's median time of 3
   with its exchange and stencil alone (the OI the rest), peak memory;
   K2 and K3 on a sharded tile (1014 x 1014) against their plain versions.
13. the command-line client (python -m gridpp_tpu_torch) at MEPS size: a
   NetCDF3 file (scipy) of phase 10's 949 x 739 grid, relief and 24 leads
   of temperature, to a 2000 x 2000 template with altitude, four output
   variables (-vi air_temperature_2m -v ... -d bilinear, three of them
   with -c neighbourhood radius=7 stat=mean / max / std): in a subprocess
   on the card (wall clock, exit 0), in this process under host() and on
   the card (one K1, K2 and K3 launch a lead); card against host():
   bilinear rtol 1e-6, atol 1e-4, Mean K1's bars, Max equal, Std (a 280 K
   field, ROADMAP F14) against float64 on each route's bilinear field,
   the card's error quantiles at most 2x the host's; K1, K2 and K3 on the
   calibrator's 2000 x 2000 slice against their plain versions (K1, K2
   against avg_pool2d / max_pool2d); then -c oi (Box-Cox, single-member:
   its back-transform smoothing is four K1 launches a lead) on a 256 x 256
   cut, 2 leads, the ~150 stations inside it: card vs host() within 1e-3.

14. the port's tools (gridpp_tpu_torch.tools), each as its
   `python -m gridpp_tpu_torch.tools.<name>` runs it: the all-API smoke on
   both routes (every top-level call leaves the card untouched, every
   device-route call allocates on it, the entry points launch K1-K5;
   SMOKE PASS, no uncovered name); the parity sweep over seeds 0-9, every
   pipeline on the card against its API function on the host route and
   on the card route within 1e-2 at every gridpoint; the per-operator
   table at -s 1 -n 3 on the host route and the card route, each card
   row within its bar of the host's, launch counts set to 0 before it:
   K1 at 10000 x 10000 (the row's zeros; also on a 280 K field with 10%
   NaN), K2 and K4 at 2000 x 2000 held against their plain versions,
   timed beside them, avg_pool2d and max_pool2d; the scaling harness, 2
   gloo CPU ranks at 512 x 512 with 2,000 obs, its first step timed (the
   reference times three after a warm one), the gathered analysis equal
   to one rank's bit for bit.
15. the roofline (gridpp_tpu_torch.tools.roofline at scale 1, as `python
   -m gridpp_tpu_torch.tools.roofline` runs it): tools/roofline.py's eight
   rows (K1 Mean and K2 Max at 2048 x 2048 h=7, K4 at T=11, the plain
   versions of K1 and K4, the EnSI update's kernel at B=16384, E=10,
   S=10, the dense OI block at B=16384, P=4096, S=10, the tiled re-solve
   at 512 x 512 with 4096 obs), the EnSI update's plain chain beside its
   kernel at B=16384 and both at the ensemble cell's B=2^20 (10,000 obs;
   bound: the FMAs the kernel issues), then K1-K5 at the main path's sizes
   (2000 x 2000,
   h=7, T=11, 10 members) and their wide route at h=100; each row held to
   its plain version, timed warm and cold, beside its bound and its
   library call (K1, K2, K5); prints the table; checks every row's times
   and bound, its shares at most 105%, and that the rows launched every
   kernel source.
16. the port's bench: the host-card copy rates of bench.py's 16 MB field
   and 160 MB ensemble (pageable and pinned, with the host's finiteness
   check and pinned copies; link_rates), then `python -m
   gridpp_tpu_torch.tools.bench --repeats 3` at full size in a subprocess
   (--repeats 1 when less than BENCH_PHASE_S of the script's 1200 s is
   left): exit 0 within 300 s, its line's keys bench.py's and the four
   additions, every number finite and positive, backend cuda, its checks
   (general == general_resolve bit for bit, serve_stream == the serial
   loop) passed and one K1 launch a deterministic cycle; its line printed
   on a line of its own. Then Pipeline.serve_stream over 4 cycles under
   torch.profiler: equal to a loop of __call__ bit for bit, with a
   device-to-host copy overlapping a kernel; warm, the tool's serial loop
   and serve_stream on those cycles in turn, three times each, and the
   host's finiteness check of a cycle's field; K1 on the field against its
   plain version and avg_pool2d, with the tool's and the trace's
   launches.

Any failed check raises. The line before the last is a JSON record of the
kernels (K1-K5; K1's launches those of phase 5's h=7 cycles and phase
10's LinearRegression call, K3's those of phase 6's Std cycles and call,
K4's phase 6's two calls; the wide route of K1, whose launches are phase
5's h=100 cycles; K1 on phase 11's neighbourhood_score path, one entry a
halfwidth; K1 on phase 12's padded tile, K2 and K3 on its sharded tiles,
K1, K2 and K3 in phase 13's CLI; K1, K2 and K4 in phase 14's table; K1
on phase 16's bench tool and serve_stream cycles; the general graph's
conditional node, with phase 5's general replays and the traces' numbers
under `graphs`), each with its time hot (`ms`), cold (`cold_ms`, but the
conditional's one-byte flag) and the bound of its count;
the last line is {"ok": true, "device": {...}}. Each phase's seconds are
printed as the next begins.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

K1_RTOL, K1_ATOL = 1e-5, 1e-4    # tests/test_pallas_stencil.py:36-38
K3_RTOL, K3_ATOL = 2e-5, 2e-3    # tests/test_pallas_stencil.py:220
FAST_TOL = 1e-3                  # tests/test_pipeline_consistency.py:86
CARD_CPU_TOL = 1e-3
# card vs CPU of the ensemble pipelines: the E x E products and sums run in
# other orders; the Newton-Schulz transform (EnSI, utem) amplifies that
ENS_CARD_CPU_TOL = {"ensi": 2e-3, "utem": 2e-3, "ebe": 1e-3, "ebesc": 1e-3}
N_ENS = 10
CYCLES = 5
PALLAS = "gridpp_tpu/ops/pallas_stencil.py"


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def field(rng, shape, nan_frac, mean=0.0, std=10.0):
    x = rng.normal(mean, std, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def compare(got, want, tol):
    """(ok, max abs difference) of got against want: NaN in the same
    places, and equal (tol None) or within (rtol, atol) elsewhere."""
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    err = float(torch.nan_to_num(got - want).abs().max()) if got.numel() \
        else 0.0
    if tol is None:
        ok = bool(torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))
    else:
        ok = bool(torch.allclose(got, want, rtol=tol[0], atol=tol[1],
                                 equal_nan=True))
    return same_nan and ok, err


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


def device_ms(fn, reps=20, by_kernel=False, at_least=None):
    """Mean device (kernel) time of fn() over reps calls from
    torch.profiler's CUPTI trace, host overhead excluded; None when the
    trace shows no device time. by_kernel: {kernel name: ms a call}
    instead. at_least: a trace below it (a partial one) is taken again, up
    to three times in all, and None (not measured) when none reaches it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3 if at_least is not None else 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / reps / 1e3
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if by_kernel:
            return times
        total = sum(times.values()) or None
        if at_least is None or (total or 0.0) >= at_least:
            return total
    return None


def bound_ms(kind, shape, h, t=0, stat=0):
    """The least time on this card of kernel `kind` ("K1"-"K5") on a field
    of `shape` at halfwidth h (K4: t thresholds; K5: statistic stat): the
    bytes and operations of gridpp_tpu_torch.tools.roofline.count over the
    card's published peaks (roofline.peaks); returns (ms, "bytes" or
    "operations")."""
    from gridpp_tpu_torch.tools import roofline
    found = roofline.peaks()
    if found is None:
        raise AssertionError("no published peaks for "
                             f"{torch.cuda.get_device_name()}")
    row = roofline.Row(kind, kind, tuple(int(d) for d in shape), h, t, stat)
    return roofline.bound(roofline.count(row), found[1])


def cold_ms(fn, *args):
    """Mean ms of fn(*args) with its inputs outside the L2 cache
    (gridpp_tpu_torch.tools.roofline.cold_ms: calls rotated over copies
    of args)."""
    from gridpp_tpu_torch.tools import roofline
    return roofline.cold_ms(fn, args)


def bench_problem(n=2000, p=10000):
    """The configuration of bench.py:57-69, seed 0: its draws as
    gridpp_tpu_torch.tools.bench.field_draws makes them."""
    from gridpp_tpu_torch.tools import bench
    return bench.field_draws(np.random.default_rng(0), n, p)


def run_cycles(pipe, bgs, obs, gap, rat):
    """CYCLES cycles of the fast, general and resolve paths, then one
    obs-gap cycle of general and of resolve; checks them and returns the
    number of cycles run."""
    def run(path, i, po=None):
        t = time.perf_counter()
        out = pipe.run_device(bgs[i], obs[i] if po is None else po, rat,
                              assume_valid=po is None, path=path)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    outs, times = {}, {}
    for path in ("fast", "general", "resolve"):
        res = [run(path, i) for i in range(CYCLES)]
        outs[path] = [r[0] for r in res]
        times[path] = [r[1] for r in res]
    gap_general, _ = run("general", 0, gap)
    gap_resolve, _ = run("resolve", 0, gap)
    for path in outs:
        check(all(bool(torch.isfinite(o).all()) for o in outs[path]),
              f"{path}: every output finite, shape "
              f"{tuple(outs[path][0].shape)}")
    for i in range(CYCLES):
        check(torch.equal(outs["general"][i], outs["resolve"][i]),
              f"cycle {i}: general == resolve bit for bit")
    check(torch.equal(gap_general, gap_resolve),
          "obs-gap cycle (rebuild): general == resolve bit for bit")
    fast_d = max(float((f - g).abs().max())
                 for f, g in zip(outs["fast"], outs["general"]))
    check(fast_d <= FAST_TOL, f"fast within {FAST_TOL} of general "
                              f"(max|d|={fast_d:.3g})")
    for path in outs:
        med = statistics.median(times[path])
        print(f"  {path}: median cycle {med * 1e3:.3f} ms over {CYCLES} "
              f"({', '.join(f'{t * 1e3:.3f}' for t in times[path])} ms)",
              flush=True)
    return 3 * CYCLES + 2


GRAPH_REBUILT = {0, 3, 5, 7}
GRAPH_TRACE_CYCLES = 3


def graph_cycles(background, pobs, ratios, dev):
    """The 8-cycle validity/ratios sequence (tests/test_torch_cuda.py::
    _graph_cycles) as (background, pobs, ratios) tensors: cold; hit; hit;
    a third of the obs missing; hit; all valid again; hit; ratios 0.05;
    each cycle's field and obs shifted by its number."""
    gap = pobs.copy()
    gap[::3] = np.nan
    other = np.full_like(ratios, 0.05)
    return [(torch.as_tensor(background + np.float32(0.5 * i), device=dev),
             torch.as_tensor((gap if i in (3, 4) else pobs) + np.float32(i),
                             device=dev),
             torch.as_tensor(other if i == 7 else ratios, device=dev))
            for i in range(8)]


def busy_us(events):
    """Microseconds in which at least one of the events (device kernels and
    copies of a trace) ran: the union of their intervals."""
    total, end = 0, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = e.time_range.start, e.time_range.end
        if end is None or lo >= end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def graph_trace(label, run):
    """Graphed cycles run(i), warm: GRAPH_TRACE_CYCLES x 4 chained ones
    timed by the host clock (the host's enqueue ms a cycle, and ms a cycle
    up to a synchronised device), then GRAPH_TRACE_CYCLES under
    torch.profiler, after one in its warm-up step: host ms a cycle, device
    ms a cycle (busy_us: the union of its kernels and copies), the idle
    share of the profiled window and of the unprofiled chained cycle,
    kernels a cycle and K1's (the strip kernel's) launches. A trace
    that shows fewer K1 launches than cycles (a partial one) is taken
    again, up to three times in all. Printed and returned as a dict."""
    n = GRAPH_TRACE_CYCLES
    run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(4 * n):
        run(i % n)
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    chained = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        # one cycle in the profiler's warm-up step, then the n recorded
        with torch.profiler.profile(
                activities=acts, acc_events=True,
                schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                 active=1)) as prof:
            run(0)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            for i in range(n):
                run(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
        # the step's own annotation spans the step on the device too
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        kernels = [e for e in events if not e.name.startswith(("Memcpy",
                                                               "Memset"))]
        k1 = sum("strip_kernel" in e.name for e in kernels)
        if k1 >= n:
            break
        names = {}
        for e in kernels:
            names[e.name[:50]] = names.get(e.name[:50], 0) + 1
        print(f"  {label}: trace {attempt} shows K1 {k1} times in {n} "
              f"cycles ({len(kernels)} kernels: {names}): a partial trace, "
              "taken again", flush=True)
    dev_us = busy_us(events)
    out = {"enqueue_ms": enqueue / (4 * n) * 1e3,
           "chained_ms": chained / (4 * n) * 1e3,
           "host_ms": wall / n * 1e3, "device_ms": dev_us / n / 1e3,
           "idle": 1 - dev_us / 1e6 / wall, "kernels": len(kernels) / n,
           "k1": k1}
    out["idle_chained"] = 1 - out["device_ms"] / out["chained_ms"]
    print(f"  {label}, graphed: {4 * n} chained cycles {out['chained_ms']:.3f}"
          f" ms a cycle (host enqueue {out['enqueue_ms']:.3f} ms); {n} under "
          f"torch.profiler: host {out['host_ms']:.3f} ms a cycle, device "
          f"{out['device_ms']:.3f} ms a cycle, idle share {out['idle']:.3f} "
          f"(of the chained cycle {out['idle_chained']:.3f}), "
          f"{out['kernels']:.1f} kernels a cycle, K1 {k1} in {n}",
          flush=True)
    return out


def graph_checks(gt, stencil, dev, pipe, background, pobs, ratios):
    """Phase 5's checks of the captured cycles on its Pipeline (bench.py's
    configuration, Mean h=7), after load_state gives it a fresh guard: the
    8-cycle sequence through the general graph (general == resolve bit for
    bit every cycle, rebuilds exactly on cycles 0, 3, 5, 7 by the
    `rebuilds` counter, each returned analysis unchanged after the next
    cycle, K1 once a cycle and the conditional's setter once a replay);
    replays of general (pratios None, numpy unlike the static ratios, a
    tensor) and fast (assume_valid) under set_sync_debug_mode("error");
    serve_stream on the general path (ratios unlike the static ones, a
    rebuild each cycle) against a loop of __call__ bit for bit; a
    torch.profiler trace of 3 warm graphed general and fast cycles, K1
    once a replay in it."""
    from gridpp_tpu_torch.ops import graph
    t0 = time.perf_counter()
    pipe.load_state(pipe.state())
    check(int(pipe.rebuilds) == 0, "load_state: a fresh guard, graphs "
          "dropped")
    cycles = graph_cycles(background, pobs, ratios, dev)
    k1 = stencil.neighbourhood_mean_cuda
    k1.launches = graph.begin_if.launches = 0
    general, kept, counts = [], [], []
    for b, po, ra in cycles:
        general.append(pipe.run_device(b, po, ra, path="general"))
        kept.append(general[-1].clone())
        counts.append(int(pipe.rebuilds))
    n = len(cycles)
    check(k1.launches == n and graph.begin_if.launches == n - 1,
          f"{n} general cycles: K1 {k1.launches} launches (one eager, one "
          f"a replay), the setter {graph.begin_if.launches} (one a replay)")
    rebuilt = {i for i, c in enumerate(counts)
               if c != (counts[i - 1] if i else 0)}
    check(rebuilt == GRAPH_REBUILT, f"rebuilds on cycles {sorted(rebuilt)}"
          f" (counter {counts})")
    same = [torch.equal(g, pipe.run_device(b, po, ra, path="resolve"))
            for g, (b, po, ra) in zip(general, cycles)]
    check(all(same), f"general == resolve bit for bit on all {n} cycles")
    check(all(torch.equal(g, k) for g, k in zip(general, kept))
          and all(bool(torch.isfinite(g).all()) for g in general),
          "every returned analysis finite and unchanged by later cycles")

    bgs = [c[0] for c in cycles[:3]]
    po = cycles[0][1]
    other = np.full(ratios.shape, 0.2, np.float32)
    forms = {"general, pratios None": dict(path="general"),
             "general, numpy pratios": dict(path="general", pratios=other),
             "general, tensor pratios": dict(
                 path="general", pratios=torch.as_tensor(other, device=dev)),
             "fast": dict(path="fast", assume_valid=True)}
    for kw in forms.values():
        pipe.run_device(bgs[0], po, **kw)
    torch.cuda.synchronize()
    outs = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for label, kw in forms.items():
            outs[label] = [pipe.run_device(b, po, **kw) for b in bgs[1:]]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for label, kw in forms.items():
        pr = kw.get("pratios", ratios)
        want = [pipe.run_device(b, po, pr, path="resolve") for b in bgs[1:]]
        if kw["path"] == "general":
            ok = all(torch.equal(g, w) for g, w in zip(outs[label], want))
        else:
            ok = max(float((g - w).abs().max())
                     for g, w in zip(outs[label], want)) <= FAST_TOL
        check(ok, f"{label}: {len(bgs) - 1} replays under "
                  "set_sync_debug_mode('error'), no host synchronisation, "
                  "answers as resolve's")

    host = [(background + np.float32(i), pobs + np.float32(i),
             ratios * np.float32(1.5 + i)) for i in range(3)]
    streamed = list(pipe.serve_stream(host))
    looped = [pipe(*c) for c in host]
    check(len(streamed) == len(host) and all(
        np.array_equal(a, b) for a, b in zip(streamed, looped)),
        f"serve_stream on the general path: {len(host)} analyses == a loop "
        "of __call__ bit for bit")

    traces = {}
    for label, kw in (("general", dict(path="general")),
                      ("fast", dict(path="fast", assume_valid=True))):
        traces[label] = graph_trace(label, lambda i: pipe.run_device(
            bgs[i], po, **kw))
        check(traces[label]["k1"] == GRAPH_TRACE_CYCLES,
              f"{label}: K1's kernel once a replay in the trace")
    print(f"  graph checks {time.perf_counter() - t0:.3f} s", flush=True)
    return traces


def cond_entry(launches, traces):
    """The `kernels` entry of the general graph's conditional (the setter
    kernel of csrc/graph_cond.cu and its IF node): a graph of the setter
    and an IF node whose body adds 1 to a count, replayed on 50 flags,
    against the plain version (the host reads the flag and adds); a
    replay's time beside the plain version's; bound: one byte read and one
    operation (tools.roofline.bound)."""
    from gridpp_tpu_torch.ops import graph
    from gridpp_tpu_torch.tools import roofline
    dev = torch.device("cuda", torch.cuda.current_device())
    flags = [True, False, True, True, False] * 10
    on = {f: torch.tensor(f, device=dev) for f in (True, False)}
    count = torch.zeros((), dtype=torch.int64, device=dev)
    g = graph.Graphed(dev, torch.cuda.graph_pool_handle())
    before = graph.begin_if.launches

    def body(p):
        g.if_node(p, lambda: count.add_(1))
        return count

    g.capture(body, (on[True],))
    for f in flags:
        card = g(on[f])
    plain = torch.zeros((), dtype=torch.int64, device=dev)

    def host_branch(p):
        if bool(p):
            plain.add_(1)
        return plain

    for f in flags:
        host_branch(on[f])
    err = abs(int(card) - int(plain))
    check(err == 0 and int(card) == sum(flags),
          f"the conditional on {len(flags)} flags: {int(card)} bodies run, "
          f"the host's branch {int(plain)}")
    entry = {"name": "gc_begin_if (the general graph's conditional node)",
             "route": "cuda",
             "source": "gridpp_tpu_torch/csrc/graph_cond.cu",
             "replaces": "gridpp_tpu/api/pipeline.py:257",
             "launches": launches, "max_abs_err": float(err),
             "ms": event_ms(lambda: g(on[True])),
             "plain_ms": event_ms(lambda: host_branch(on[True]))}
    times = device_ms(lambda: g(on[False]), by_kernel=True)
    entry["device_ms"] = next((v for k, v in (times or {}).items()
                               if "set_conditional" in k), None)
    entry["bound_ms"], entry["bound_by"] = roofline.bound(
        (1, 1, "int32"), roofline.peaks()[1])
    entry["library_ms"] = None
    entry["graphs"] = traces
    graph.begin_if.launches = before
    g.close()
    print(f"  the conditional: a replay {entry['ms']:.4f} ms (setter alone "
          f"{entry['device_ms']}), the host's branch {entry['plain_ms']:.4f}"
          f" ms, bound {entry['bound_ms']:.3g} ms", flush=True)
    return entry


def lap(laps):
    """Mark a phase's start in laps (host-clock seconds) and print the
    time since the previous mark."""
    laps.append(time.perf_counter())
    if len(laps) > 2:
        print(f"  ({laps[-1] - laps[-2]:.3f} s)", flush=True)


def timed(fn):
    """fn() and its host-clock seconds, up to a synchronised device."""
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def on_card(dev, fn):
    """fn with dev as torch's default device: an API module function's
    device route on the card."""
    def run(*args):
        with torch.device(dev):
            return fn(*args)
    return run


def report(name, times):
    print(f"  {name}: median cycle {statistics.median(times) * 1e3:.3f} ms "
          f"over {len(times)} ({', '.join(f'{t * 1e3:.3f}' for t in times)}"
          " ms)", flush=True)


def ensemble_phase(gt, stencil, dev, grid, points, pback, obs, gap, ratios):
    """Phase 7. Returns (K5's launches on the Mean-smoothed EnSI path, K3's
    on the Std-smoothed one, the numpy ensemble, the structure object every
    ensemble pipeline shared)."""
    rng = np.random.default_rng(3)
    n, p = grid.size()[0], points.size()
    # one structure object: canonical_shortlist's cache (keyed on its id)
    # then builds the 20-candidate shortlist once for every pipeline
    structure = gt.BarnesStructure(10000.0)
    ens_np = rng.normal(280, 5, (n, n, N_ENS)).astype(np.float32)
    ens = torch.as_tensor(ens_np, device=dev)
    bgs = [ens + float(i) for i in range(CYCLES)]
    del ens
    psig = torch.full((p,), 1.5, device=dev)
    rat = torch.as_tensor(ratios, device=dev)
    pobs_e = torch.as_tensor((pback[:, None] + rng.normal(
        0, 1, (p, N_ENS))).astype(np.float32), device=dev)

    def build(cls, **kw):
        t0 = time.perf_counter()
        pipe = cls(grid, points, structure, max_points=10, device=dev, **kw)
        torch.cuda.synchronize()
        args = ", ".join(f"{k}={getattr(v, 'name', v)}" for k, v in kw.items())
        print(f"  {cls.__name__}({args}): host set-up "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        return pipe

    from gridpp_tpu_torch.ops.oi_ensi import ensi_update_cuda
    k5 = 0
    for h in (0, 7):
        pipe = build(gt.EnsiPipeline, halfwidth=h,
                     statistic=gt.Statistic.Mean)
        stencil.neighbourhood_members_cuda.launches = 0
        ensi_update_cuda.launches = 0
        fast = [timed(lambda: pipe.run_device(bgs[i], obs[i], psig,
                                              assume_valid=True))
                for i in range(CYCLES)]
        general = [timed(lambda: pipe.run_device(bgs[i], obs[i], psig))
                   for i in range(CYCLES)]
        gap_out, _ = timed(lambda: pipe.run_device(bgs[0], gap, psig))
        launches = stencil.neighbourhood_members_cuda.launches
        n_cycles = 2 * CYCLES + 1
        check(launches == (n_cycles if h else 0),
              f"EnSI h={h}: {launches} K5 launches in {n_cycles} cycles")
        blocks = -(-n * n // pipe.block)
        check(ensi_update_cuda.launches == n_cycles * blocks,
              f"EnSI h={h}: {ensi_update_cuda.launches} EnSI kernel "
              f"launches in {n_cycles} cycles of {blocks} blocks")
        for i in range(CYCLES):
            check(torch.equal(fast[i][0][0], general[i][0][0]),
                  f"EnSI h={h} cycle {i}: fast == general bit for bit")
        outs = [r[0] for r in fast + general] + [gap_out]
        check(all(bool(torch.isfinite(o).all()) for o, _ in outs)
              and outs[0][0].shape == (n, n, N_ENS),
              f"EnSI h={h}: every output finite, shape "
              f"{tuple(outs[0][0].shape)}")
        check(all(int(c) == 0 for _, c in outs),
              f"EnSI h={h}: no condition failures in {n_cycles} cycles")
        report(f"EnSI h={h} fast", [t for _, t in fast])
        report(f"EnSI h={h} general", [t for _, t in general])
        if h:
            k5 = launches
        del pipe, fast, general, outs, gap_out
    # Std h=7: one batched K3 launch on the (E, Y, X) member planes a
    # cycle; obs of the smoothed members' mean, so the analysis stays near
    # its background
    pipe = build(gt.EnsiPipeline, halfwidth=7, statistic=gt.Statistic.Std)
    nn = torch.as_tensor(grid.nearest_map(points.lats, points.lons),
                         device=dev)
    smoothed = stencil.neighbourhood_var_plain(
        bgs[0].permute(2, 0, 1).contiguous(), 7, 7, int(gt.Statistic.Std))
    sd_obs = smoothed.mean(dim=0).reshape(-1)[nn] + torch.as_tensor(
        rng.normal(0, 0.1, p).astype(np.float32), device=dev)
    del smoothed
    stencil.neighbourhood_var_cuda.launches = 0
    res = [timed(lambda: pipe.run_device(bgs[i], sd_obs + 0.01 * i, psig))
           for i in range(3)]
    k3 = stencil.neighbourhood_var_cuda.launches
    check(k3 == len(res), f"EnSI Std h=7: {k3} K3 launches in {len(res)} "
                          "cycles")
    check(all(bool(torch.isfinite(o).all()) and int(c) == 0
              for (o, c), _ in res),
          "EnSI Std h=7: every output finite, no condition failures")
    report("EnSI Std h=7 general", [t for _, t in res])
    del pipe, res, sd_obs
    for variant in ("ebesc", "ebe", "utem"):
        pipe = build(gt.MultiEnsiPipeline, variant=variant)

        def cycle(i):
            if variant == "utem":
                return pipe.run_device(bgs[i], obs[i], rat, bgs[i])
            return pipe.run_device(bgs[i], pobs_e + 0.01 * i, rat,
                                   bgs[i] if variant == "ebe" else None)

        res = [timed(lambda: cycle(i)) for i in range(CYCLES)]
        check(all(bool(torch.isfinite(o).all()) for (o, _), _ in res),
              f"{variant}: every output finite")
        if variant == "utem":
            check(all(int(c) == 0 for (_, c), _ in res),
                  "utem: no condition failures")
        report(variant, [t for _, t in res])
        del pipe, res
    return k5, k3, ens_np, structure


API_TOL = 1e-2      # tests/test_parity_dense.py:10, :37, :65, :101
API_CLOSE = 2e-4    # the share of cells this close is printed
API_DENSE_SHARE = 0.999
API_FUNCS = ("oi", "full", "ensi", "ebe", "ebesc", "utem")


def instrument(module, name, stats):
    """Replace module.name by a wrapper that counts its calls and adds its
    wall time, up to a synchronised device, to stats[name] = [calls, s]."""
    real = getattr(module, name)
    stats[name] = [0, 0.0]

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        stats[name][0] += 1
        stats[name][1] += time.perf_counter() - t
        return out

    setattr(module, name, wrapper)


def starved_rows(grid, points, structure, pobs, max_points=10):
    """Rows whose canonical shortlist is truncated and keeps fewer than
    max_points valid obs under pobs (the device route's fallback
    condition, api/oi.py)."""
    from gridpp_tpu_torch.ops.canonical import canonical_shortlist
    sl = canonical_shortlist(grid.to_points(), points, structure,
                             2 * max_points)
    cnt = (np.isfinite(pobs)[sl.sel] & sl.valid).sum(axis=1)
    return sl.truncated & (cnt < max_points)


def api_calls(grid, points, structure, bg, ens, ratios, idx, owners):
    """The six OI API functions on one network: name -> fn(pobs, pobs_e)
    calling the function of owners[name] (the port's top level or its api
    module); pobs_e are the perturbed obs (P, E) of ebe and ebesc."""
    e = ens.shape[2]
    pback = bg.reshape(-1)[idx]
    pback_e = ens.reshape(-1, e)[idx]
    bratios = np.ones(bg.shape, np.float32)
    psig = np.full(points.size(), 1.5, np.float32)
    ones = np.ones(bg.shape, np.float32)
    pones = np.ones(points.size(), np.float32)
    return {
        "oi": lambda po, pe: owners["oi"].optimal_interpolation(
            grid, bg, points, po, ratios, pback, structure, 10),
        "full": lambda po, pe: owners["full"].optimal_interpolation_full(
            grid, bg, ones, points, po, ratios, pback, pones, structure,
            10),
        "ensi": lambda po, pe: owners["ensi"].optimal_interpolation_ensi(
            grid, ens, points, po, psig, pback_e, structure, 10),
        "ebe": lambda po, pe: owners["ebe"].
        optimal_interpolation_ensi_multi_ebe(
            grid, bratios, ens, ens, points, pe, ratios, pback_e, pback_e,
            structure, 10),
        "ebesc": lambda po, pe: owners["ebesc"].
        optimal_interpolation_ensi_multi_ebesc(
            grid, bratios, ens, points, pe, ratios, pback_e, structure, 10),
        "utem": lambda po, pe: owners["utem"].
        optimal_interpolation_ensi_multi_utem(
            grid, bratios, ens, ens, points, po, ratios, pback_e, pback_e,
            structure, 10),
    }


def api_phase(gt, dev, grid, points, structure, background, pobs, ratios,
              idx, ens_np, cut):
    """Phase 9: gridpp's OI numpy API through its device route (the api
    modules' functions under the card as torch's default device)."""
    from gridpp_tpu_torch.api import oi as tapi
    from gridpp_tpu_torch.api import oi_ensi as tensi
    from gridpp_tpu_torch.api import oi_ensi_multi as tmulti
    stats = {}
    for mod, names in (
            (tapi, ("_oi_points_dense", "oi_shortlist_sweep",
                    "oi_dense_sweep", "oi_gather_block")),
            (tensi, ("ensi_shortlist_sweep", "ensi_dense_sweep",
                     "ensi_kernel")),
            (tmulti, ("member_serve_sweep", "utem_serve_sweep",
                      "ebe_kernel", "ebesc_kernel", "utem_kernel"))):
        for name in names:
            instrument(mod, name, stats)

    def reset():
        for v in stats.values():
            v[:] = [0, 0.0]

    def count(*names):
        return sum(stats[n][0] for n in names)

    sweeps = {"oi": ("oi_shortlist_sweep",), "full": ("oi_shortlist_sweep",),
              "ensi": ("ensi_shortlist_sweep",),
              "ebe": ("member_serve_sweep",),
              "ebesc": ("member_serve_sweep",),
              "utem": ("utem_serve_sweep",)}
    fallbacks = {"oi": ("_oi_points_dense", "oi_gather_block"),
                 "full": ("_oi_points_dense", "oi_gather_block"),
                 "ensi": ("ensi_dense_sweep", "ensi_kernel"),
                 "ebe": ("ebe_kernel",), "ebesc": ("ebesc_kernel",),
                 "utem": ("utem_kernel",)}
    module_of = {"oi": tapi, "full": tapi, "ensi": tensi, "ebe": tmulti,
                 "ebesc": tmulti, "utem": tmulti}

    n, p, e = grid.size()[0], points.size(), ens_np.shape[2]
    rng = np.random.default_rng(6)
    pback_e = ens_np.reshape(-1, e)[idx]
    pobs_e = (pback_e + rng.normal(0, 1, (p, e))).astype(np.float32)
    card = {k: on_card(dev, f) for k, f in api_calls(
        grid, points, structure, background, ens_np, ratios, idx,
        module_of).items()}
    rat = torch.as_tensor(ratios, device=dev)

    # -- the deterministic OI against Pipeline(halfwidth=0) resolve --
    t0 = time.perf_counter()
    pipe = gt.Pipeline(grid, points, structure, halfwidth=0, max_points=10,
                       ratios=ratios, device=dev)
    torch.cuda.synchronize()
    print(f"  Pipeline(halfwidth=0) on the shared shortlist: host set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    bg_t = torch.as_tensor(background, device=dev)

    def resolve(po):
        return pipe.run_device(bg_t, torch.as_tensor(po, device=dev), rat,
                               path="resolve").cpu().numpy()

    few = pobs.copy()
    few[::97] = np.nan
    check(not starved_rows(grid, points, structure, few).any(),
          f"{int(np.isnan(few).sum())} obs missing starve no row")
    for label, po in (("all obs valid", pobs), ("a few obs missing", few)):
        reset()
        out = card["oi"](po, pobs_e)
        check(count("_oi_points_dense") == 0
              and count("oi_shortlist_sweep") == 1,
              f"optimal_interpolation ({label}): the shortlist route "
              "(_oi_points_dense not called)")
        check(bool(np.isfinite(out).all()) and out.shape == (n, n),
              f"optimal_interpolation ({label}): finite, {out.shape}")
        d = float(np.abs(out - resolve(po)).max())
        check(d < API_TOL, f"optimal_interpolation ({label}) vs Pipeline "
                           f"resolve: max|d|={d:.3g} at every cell")
    out, avar = card["full"](pobs, pobs_e)
    check(bool(np.isfinite(avar).all()) and float(avar.max()) <= 1.0 + 1e-5,
          f"optimal_interpolation_full: analysis variance finite and <= "
          f"bvariance + 1e-5 (max {float(avar.max()):.6f})")

    # -- the starved fallback: the dense all-obs sweep --
    gap = pobs.copy()
    plats, plons = points.lats, points.lons
    gap[(plats > 58.0) & (plats < 59.0) & (plons > 8.0) & (plons < 9.0)] = \
        np.nan
    starved = starved_rows(grid, points, structure, gap).reshape(n, n)
    check(bool(starved.any()), f"{int(np.isnan(gap).sum())} obs dropped in "
                               f"a box starve {int(starved.sum())} rows")
    reset()
    dense_out, dense_s = timed(lambda: card["oi"](gap, pobs_e))
    check(count("_oi_points_dense") == 1 and count("oi_dense_sweep") == 1,
          f"starved call: the dense sweep ran ({dense_s:.3f} s wall, "
          f"sweep {stats['oi_dense_sweep'][1]:.3f} s)")
    d = np.abs(dense_out - resolve(gap))[~starved]
    share = float((d < API_TOL).mean())
    check(bool(np.isfinite(dense_out).all()) and share >= API_DENSE_SHARE,
          f"dense vs resolve on the {int((~starved).sum())} rows not "
          f"starved: {share:.6f} of cells within {API_TOL}, max|d|="
          f"{float(d.max()):.3g}")

    # -- the ensemble functions against their pipelines --
    ens_t = torch.as_tensor(ens_np, device=dev)
    obs_t = torch.as_tensor(pobs, device=dev)
    psig_t = torch.full((p,), 1.5, device=dev)
    pe_t = torch.as_tensor(pobs_e, device=dev)
    ensi_pipe = gt.EnsiPipeline(grid, points, structure, halfwidth=0,
                                max_points=10, device=dev)
    cycles = {"oi": lambda: pipe.run_device(bg_t, obs_t, rat,
                                            path="resolve"),
              "ensi": lambda: ensi_pipe.run_device(ens_t, obs_t, psig_t)}
    reset()
    out = card["ensi"](pobs, pobs_e)
    want, n_cond = cycles["ensi"]()
    d = float(np.abs(out - want.cpu().numpy()).max())
    check(count("ensi_shortlist_sweep") == 1 and count(*fallbacks["ensi"])
          == 0 and int(n_cond) == 0 and bool(np.isfinite(out).all())
          and d < API_TOL,
          f"optimal_interpolation_ensi vs EnsiPipeline(halfwidth=0) "
          f"general: max|d|={d:.3g} (bit for bit: "
          f"{bool(np.array_equal(out, want.cpu().numpy()))})")
    del want
    for variant in ("ebesc", "ebe", "utem"):
        mpipe = gt.MultiEnsiPipeline(grid, points, structure,
                                     variant=variant, max_points=10,
                                     device=dev)
        po = obs_t if variant == "utem" else pe_t
        corr = None if variant == "ebesc" else ens_t
        cycles[variant] = (lambda m=mpipe, po=po, corr=corr:
                           m.run_device(ens_t, po, rat, corr))
        reset()
        out = card[variant](pobs, pobs_e)
        want = cycles[variant]()[0].cpu().numpy()
        d = float(np.abs(out - want).max())
        check(count(*sweeps[variant]) == 1
              and count(*fallbacks[variant]) == 0
              and bool(np.isfinite(out).all()) and d < API_TOL,
              f"optimal_interpolation_ensi_multi_{variant} vs "
              f"MultiEnsiPipeline({variant}): max|d|={d:.3g} (bit for bit: "
              f"{bool(np.array_equal(out, want))})")
        del want

    # -- call times: numpy in and out, wall clock --
    for name in API_FUNCS:
        reset()
        times = [timed(lambda: card[name](pobs, pobs_e))[1]
                 for _ in range(3)]
        sweep = sum(stats[k][1] for k in sweeps[name]) / 3
        cyc = cycles.get(name, cycles["oi"] if name == "full" else None)
        ctimes = [timed(cyc)[1] for _ in range(3)]
        label = {"oi": "Pipeline(h=0) resolve", "full": "Pipeline(h=0) "
                 "resolve", "ensi": "EnsiPipeline(h=0) general"}.get(
            name, f"MultiEnsiPipeline({name})")
        print(f"  {name}: median call {statistics.median(times) * 1e3:.3f}"
              f" ms over 3 ({', '.join(f'{t * 1e3:.3f}' for t in times)} "
              f"ms), of which the device sweep {sweep * 1e3:.3f} ms; "
              f"{label} cycle {statistics.median(ctimes) * 1e3:.3f} ms",
              flush=True)
    print(f"  starved call (dense sweep): {dense_s * 1e3:.3f} ms",
          flush=True)
    del pipe, ensi_pipe, cycles, ens_t
    print(f"  phase peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)

    # -- the 256^2 cut: device route against the host route --
    g2, pts2, st2, sub_bg, po2, ens2, pe2, rat2 = cut
    k = pts2.size()
    idx2 = g2.nearest_map(pts2.lats, pts2.lons)
    host = api_calls(g2, pts2, st2, sub_bg, ens2, rat2, idx2,
                     dict.fromkeys(API_FUNCS, gt))
    dev2 = {name: on_card(dev, f) for name, f in api_calls(
        g2, pts2, st2, sub_bg, ens2, rat2, idx2, module_of).items()}
    gap2, gape2 = po2.copy(), pe2.copy()
    drop = np.arange(k) % 3 != 0
    gap2[drop] = np.nan
    gape2[drop] = np.nan
    n_starved = int(starved_rows(g2, pts2, st2, gap2).sum())
    check(n_starved > 0, f"256^2 cut, {k} obs: dropping {int(drop.sum())} "
                         f"starves {n_starved} rows")
    for case, po, pe in (("shortlist", po2, pe2), ("starved", gap2, gape2)):
        for name in API_FUNCS:
            reset()
            got = dev2[name](po, pe)
            want = host[name](po, pe)
            if name != "full":
                got, want = (got,), (want,)
            d = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
            close = float(np.mean([np.mean(np.abs(a - b) < API_CLOSE)
                                   for a, b in zip(got, want)]))
            route = (count(*fallbacks[name]) > 0 if case == "starved"
                     else count(*sweeps[name]) == 1
                     and count(*fallbacks[name]) == 0)
            check(route and all(bool(np.isfinite(a).all()) for a in got)
                  and d < API_TOL,
                  f"256^2 {name} ({case} route): card vs host max|d|="
                  f"{d:.3g}, {close:.6f} of cells within {API_CLOSE}")


# -- phase 10: downscale, gradient-correct, calibrate -------------------------
DOWN_TOL = (1e-6, 1e-4)  # rtol, atol: the card route against the host route
MEPS_SHAPE = (949, 739)  # the MEPS 2.5 km grid's published size
N_LEAD = 24
LR_H, MINMAX_H = 10, 3
# LR against float64, on the cells whose variance K1's bars determine: the
# card route's error quantiles at most this factor of the host plain route's
LR_F64_QUANTILES, LR_F64_FACTOR = (0.5, 0.99, 0.999), 2.0


def waves(lats, lons, seed, wavelengths, n=4):
    """A smooth seeded field in [-1, 1] on (lats, lons): n plane waves of
    each wavelength (degrees), averaged."""
    rng = np.random.default_rng(seed)
    z = np.zeros(lats.shape)
    for wl in wavelengths:
        for _ in range(n):
            ky, kx = rng.normal(0, 2 * np.pi / wl, 2)
            z += np.sin(ky * lats + kx * lons + rng.uniform(0, 2 * np.pi))
    return z / (n * len(wavelengths))


def terrain(lats, lons, fine):
    """Seeded elevations of 0-2000 m (sea level where they would be below)
    and the land-area fraction they give, on (lats, lons): the same coarse
    relief on every grid, with finer detail where fine."""
    z = 1000 + 1800 * waves(lats, lons, 20, (2.0, 0.7))
    if fine:
        z += 150 * waves(lats, lons, 21, (0.08,))
    elev = np.clip(z, 0, 2000).astype(np.float32)
    return elev, np.clip(elev / 50.0, 0, 1).astype(np.float32)


def lr_float64(base, values, h):
    """calc_gradient LinearRegression's slope in float64 from summed-area
    tables of the five moments (window clipped at the edges, missing cells
    skipped), the default where the variance is 0 or no cell is valid: the
    yardstick of both f32 routes and the native one."""
    ok = np.isfinite(base) & np.isfinite(values)
    x = np.where(ok, base, 0).astype(np.float64)
    y = np.where(ok, values, 0).astype(np.float64)

    def window_sum(a):
        c = np.pad(a, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
        ny, nx = a.shape
        y0 = np.clip(np.arange(ny) - h, 0, ny)
        y1 = np.clip(np.arange(ny) + h + 1, 0, ny)
        x0 = np.clip(np.arange(nx) - h, 0, nx)
        x1 = np.clip(np.arange(nx) + h + 1, 0, nx)
        return (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0])

    n = window_sum(ok.astype(np.float64))
    nz = np.maximum(n, 1)
    mx, my = window_sum(x) / nz, window_sum(y) / nz
    var = window_sum(x * x) / nz - mx * mx
    cov = window_sum(x * y) / nz - mx * my
    return np.where((n >= 2) & (var != 0), cov / np.where(var == 0, 1, var),
                    0.0)


def lr_k1_entry(gt, stencil, moments, launches, err):
    """The `kernels` line's entry of K1 on calc_gradient's LinearRegression
    path: the five launches of one call on its inputs (moments: (label,
    tensor, statistic), NaN-free), timed together beside their plain
    versions and five avg_pool2d calls, with their bound."""
    k = 2 * LR_H + 1
    xs = [(x, int(stat)) for _, x, stat in moments]

    def card():
        return [stencil.neighbourhood_mean_cuda(x, LR_H, LR_H, st)
                for x, st in xs]

    def plain():
        return [stencil.neighbourhood_mean_plain(x, LR_H, LR_H, st)
                for x, st in xs]

    def library():
        return [F.avg_pool2d(x[None, None], k, 1, LR_H,
                             count_include_pad=False,
                             divisor_override=1 if st == int(gt.Sum)
                             else None)[0, 0] for x, st in xs]

    for (label, _, _), got, want in zip(moments, card(), library()):
        ok, e = compare(got, want, (K1_RTOL, K1_ATOL))
        check(ok, f"LR's {label}: the library call computes the same "
                  f"function (max|d|={e:.3g})")
    entry = {
        "name": "neighbourhood_mean_cuda (calc_gradient LinearRegression: "
                "4 Mean + 1 Sum)",
        "route": "cuda",
        "source": "gridpp_tpu_torch/csrc/neighbourhood_mean.cu",
        "replaces": f"{PALLAS}:301",
        "launches": launches, "max_abs_err": err,
        "ms": event_ms(card),
        "cold_ms": cold_ms(lambda *a: [
            stencil.neighbourhood_mean_cuda(x, LR_H, LR_H, st)
            for x, (_, st) in zip(a, xs)], *(x for x, _ in xs)),
        "device_ms": device_ms(card),
        "plain_ms": event_ms(plain, reps=10), "library_ms": event_ms(library)}
    # the five fields' work as one (5, Y, X) K1 call
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        "K1", (len(xs),) + tuple(xs[0][0].shape), LR_H)
    dev_ms = entry["device_ms"]
    print(f"  K1 on the LR path (five launches, {tuple(xs[0][0].shape)}, "
          f"h={LR_H}): kernel {entry['ms']:.4f} ms, cold "
          f"{entry['cold_ms']:.4f} ms (device only "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
          f"plain {entry['plain_ms']:.4f} ms, library "
          f"call {entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} "
          f"ms ({entry['bound_by']}), {entry['bound_ms'] / entry['ms']:.3f} "
          "of the bound", flush=True)
    return entry


def downscale_phase(gt, dev, lats, lons, plats, plons):
    """Phase 10: the MEPS 2.5 km -> 1 km path through the port's module
    functions on the card, each call held against the host route. Returns
    the `kernels` line's entry of K1 on this path (calc_gradient's
    LinearRegression), with its launches in the phase's driving calls."""
    from gridpp_tpu_torch.api import curves as tcurves
    from gridpp_tpu_torch.api import downscaling as tdown
    from gridpp_tpu_torch.api import gradients as tgrad
    from gridpp_tpu_torch.api.gradients import lr_bar
    from gridpp_tpu_torch.ops import stencil

    t0 = time.perf_counter()
    slats, slons = np.meshgrid(np.linspace(55, 62, MEPS_SHAPE[0]),
                               np.linspace(5, 12, MEPS_SHAPE[1]),
                               indexing="ij")
    selev, slaf = terrain(slats, slons, fine=False)
    oelev, olaf = terrain(lats, lons, fine=True)
    src = gt.Grid(slats, slons, selev, slaf)
    tgt = gt.Grid(lats, lons, oelev, olaf)
    rng = np.random.default_rng(10)
    p = plats.size
    pidx = tgt.nearest_map(plats, plons)
    pts = gt.Points(plats, plons,
                    oelev.reshape(-1)[pidx] + rng.normal(0, 20, p),
                    olaf.reshape(-1)[pidx])
    # temperature falling 6.5 K a km with height, and noise
    temp = (288 - 0.0065 * selev + rng.normal(0, 2, (N_LEAD,) + MEPS_SHAPE)
            ).astype(np.float32)
    laf_grad = rng.normal(1.5, 0.5, MEPS_SHAPE).astype(np.float32)
    print(f"  data {time.perf_counter() - t0:.3f} s: source {MEPS_SHAPE} x "
          f"{N_LEAD} leads, elevations {float(selev.min()):.1f}-"
          f"{float(selev.max()):.1f} m, target {tgt.size()}, {p} points",
          flush=True)
    for name, build in (
            ("nearest map to the 2000^2 grid", lambda: src.nearest_map(
                tgt.lats, tgt.lons, cache_obj=tgt)),
            ("bilinear map to the 2000^2 grid",
             lambda: tdown._bilinear_map(src, tgt)),
            ("bilinear map to the points",
             lambda: tdown._bilinear_map(src, pts))):
        _, secs = timed(build)
        print(f"  host map build, {name}: {secs:.3f} s", flush=True)
    m = tdown._bilinear_map(src, tgt)
    print(f"  bilinear map to the 2000^2 grid: "
          f"{sum(a.nbytes for a in vars(m).values()) / 1e6:.1f} MB, "
          f"{float(m.inside.mean()):.6f} of cells inside", flush=True)

    # the slice's calls: name -> (module function, its top-level twin, args)
    calls = {
        "nearest grid": (tdown.nearest, gt.nearest, (src, tgt, temp)),
        "bilinear grid": (tdown.bilinear, gt.bilinear, (src, tgt, temp)),
        "nearest points": (tdown.nearest, gt.nearest, (src, pts, temp)),
        "bilinear points": (tdown.bilinear, gt.bilinear, (src, pts, temp)),
        "calc_gradient MinMax": (tgrad.calc_gradient, gt.calc_gradient,
                                 (selev, temp[0], gt.MinMax, MINMAX_H)),
    }
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in (stencil.neighbourhood_mean_cuda,
              stencil.neighbourhood_minmax_cuda,
              stencil.neighbourhood_var_cuda,
              stencil.neighbourhood_quantile_fast_cuda,
              stencil.neighbourhood_members_cuda):
        w.launches = 0
    # -- the driving calls, counts from 0 --
    card = {}
    lr = on_card(dev, lambda: tgrad.calc_gradient(
        selev, temp[0], gt.LinearRegression, LR_H))()
    k1 = stencil.neighbourhood_mean_cuda.launches
    for name, (fn, _, args) in calls.items():
        card[name] = on_card(dev, lambda: fn(*args))()
    egrad = lr
    calls.update({
        "calc_gradient LinearRegression": (
            tgrad.calc_gradient, gt.calc_gradient,
            (selev, temp[0], gt.LinearRegression, LR_H)),
        "full_gradient": (tgrad.full_gradient, gt.full_gradient,
                          (src, tgt, temp, egrad, laf_grad, gt.Bilinear)),
        "simple_gradient": (tgrad.simple_gradient, gt.simple_gradient,
                            (src, tgt, temp, -0.0065, gt.Bilinear)),
    })
    card["calc_gradient LinearRegression"] = lr
    for name in ("full_gradient", "simple_gradient"):
        fn, _, args = calls[name]
        card[name] = on_card(dev, lambda: fn(*args))()
    down = card["full_gradient"][0]
    # a shared 101-knot quantile-mapping curve from 101 stations' pairs
    # (observation = forecast + a warm bias and noise), and per-cell
    # 11-knot curves: a line through each cell's shifted knots
    sfc = card["bilinear points"][0, :101]
    cr, cf = gt.quantile_mapping_curve(
        sfc + rng.normal(1.0, 1.5, 101).astype(np.float32), sfc)
    knots = np.linspace(262, 298, 11, dtype=np.float32)
    shift = rng.normal(0, 2, down.shape).astype(np.float32)
    pf = knots + shift[..., None]
    pr = (rng.uniform(0.9, 1.1, down.shape).astype(np.float32)[..., None]
          * pf + rng.normal(1, 1, down.shape).astype(np.float32)[..., None])
    calls.update({
        "apply_curve shared": (tcurves.apply_curve, gt.apply_curve,
                               (down, cr, cf, gt.OneToOne, gt.MeanSlope)),
        "apply_curve per cell": (tcurves.apply_curve, gt.apply_curve,
                                 (down, pr, pf, gt.NearestSlope,
                                  gt.NearestSlope)),
    })
    for name in ("apply_curve shared", "apply_curve per cell"):
        fn, _, args = calls[name]
        card[name] = on_card(dev, lambda: fn(*args))()
    launches = {w.__name__: w.launches for w in (
        stencil.neighbourhood_mean_cuda, stencil.neighbourhood_minmax_cuda,
        stencil.neighbourhood_var_cuda,
        stencil.neighbourhood_quantile_fast_cuda,
        stencil.neighbourhood_members_cuda)}
    check(k1 == 5 and launches["neighbourhood_mean_cuda"] == 5
          and sum(launches.values()) == 5,
          f"the phase's kernel launches: five K1 (four Mean, one Sum), all "
          f"in the LinearRegression call ({launches})")
    print(f"  phase peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"(f32 output of a 2000^2 x {N_LEAD} call: "
          f"{4 * N_LEAD * 4e6 / 1e6:.0f} MB)", flush=True)

    # -- each call against the host route --
    host_s = {}
    for name, (_, host_fn, args) in calls.items():
        if name == "calc_gradient LinearRegression":
            continue
        want, host_s[name] = timed(lambda: host_fn(*args))
        got = card[name]
        check(isinstance(got, np.ndarray) and got.shape == want.shape
              and got.dtype == np.float32 and bool(np.isfinite(got).any()),
              f"{name}: numpy {got.shape} f32 from the card")
        if name.startswith("nearest"):
            check(np.array_equal(got, want, equal_nan=True),
                  f"{name}: card == host route")
            continue
        d = float(np.nanmax(np.abs(got - want)))
        check(np.array_equal(np.isnan(got), np.isnan(want))
              and np.allclose(got, want, rtol=DOWN_TOL[0], atol=DOWN_TOL[1],
                              equal_nan=True),
              f"{name}: card vs host route max|d|={d:.3g} (rtol "
              f"{DOWN_TOL[0]}, atol {DOWN_TOL[1]})")

    # -- LinearRegression: K1 on its inputs, the plain route, the native --
    base = torch.as_tensor(selev, device=dev)
    vals = torch.as_tensor(temp[0], device=dev)
    moments = (("mean x", base, gt.Mean), ("mean y", vals, gt.Mean),
               ("mean xx", base * base, gt.Mean),
               ("mean xy", base * vals, gt.Mean),
               ("count", torch.isfinite(base).float(), gt.Sum))
    k1_err = 0.0
    for label, x, stat in moments:
        ok, e = compare(
            stencil.neighbourhood_mean_cuda(x, LR_H, LR_H, int(stat)),
            stencil.neighbourhood_mean_plain(x, LR_H, LR_H, int(stat)),
            (K1_RTOL, K1_ATOL))
        check(ok, f"LR's K1 {label} ({tuple(x.shape)}, h={LR_H}) vs plain: "
                  f"max|d|={e:.3g}")
        k1_err = max(k1_err, e)
    k1_entry = lr_k1_entry(gt, stencil, moments, k1, k1_err)
    plain, plain_s = timed(
        lambda: tgrad.lr_gradient(torch.from_numpy(selev),
                                  torch.from_numpy(temp[0]), LR_H, 2,
                                  gt.MV, 0.0).numpy())
    # the gradient amplifies its moments' rounding by E[xx] / var: held to
    # K1's bars carried through var and cov (ROADMAP F9), beside the count
    # of cells past K1's bars applied to the gradient itself
    bar, det = lr_bar([m.numpy() for m in tgrad.lr_moments(
        torch.from_numpy(selev), torch.from_numpy(temp[0]), LR_H)],
        K1_RTOL, K1_ATOL)
    d = np.abs(lr - plain)
    own = K1_ATOL + K1_RTOL * np.abs(plain)
    beyond = d > own
    check(bool((d <= bar + own)[det].all()),
          f"calc_gradient LinearRegression h={LR_H}: card vs the host plain "
          f"route max|d|={float(d.max()):.3g}; {int(beyond.sum())} of "
          f"{d.size} cells past K1's bars on the gradient itself (max|d| "
          f"{float(d[beyond].max()) if beyond.any() else 0.0:.3g}), every "
          f"one of the {int(det.sum())} cells whose variance K1's bars "
          f"determine within those bars carried through the regression; "
          f"{int((~det).sum())} cells undetermined (max|d| "
          f"{float(d[~det].max()) if (~det).any() else 0.0:.3g})")
    native_lr, host_s["calc_gradient LinearRegression"] = timed(
        lambda: gt.calc_gradient(selev, temp[0], gt.LinearRegression, LR_H))
    truth = lr_float64(selev, temp[0], LR_H)
    dn = np.abs(lr - native_lr)
    print(f"  LR card vs native (double sums) route: max|d|="
          f"{float(dn.max()):.6g}, "
          f"{int((dn > K1_ATOL + K1_RTOL * np.abs(native_lr)).sum())} cells "
          f"past K1's bars; gradient range {float(native_lr.min()):.6g} to "
          f"{float(native_lr.max()):.6g}", flush=True)
    f64 = {}
    for label, g in (("card", lr), ("host plain", plain),
                     ("native", native_lr)):
        e = np.abs(g - truth)
        f64[label] = np.quantile(e[det], LR_F64_QUANTILES)
        print(f"  LR {label} route vs float64: max|d|={float(e.max()):.6g} "
              f"(on the determined cells {float(e[det].max()):.6g}; their "
              f"quantiles {LR_F64_QUANTILES}: "
              f"{', '.join(f'{q:.6g}' for q in f64[label])}), "
              f"{int((e > K1_ATOL + K1_RTOL * np.abs(truth)).sum())} cells "
              "past K1's bars", flush=True)
    check(bool((f64["card"] <= LR_F64_FACTOR * f64["host plain"]).all()),
          f"LR card route vs float64 on the {int(det.sum())} determined "
          f"cells: its error quantiles {LR_F64_QUANTILES} within "
          f"{LR_F64_FACTOR}x the host plain route's")
    for kw in ({}, {"min_range": 50.0}):
        got = on_card(dev, lambda: tgrad.calc_gradient(
            selev, temp[0], gt.LinearRegression, LR_H,
            default_gradient=np.nan, **kw))()
        want = gt.calc_gradient(selev, temp[0], gt.LinearRegression, LR_H,
                                default_gradient=np.nan, **kw)
        flips = int((np.isnan(got) != np.isnan(want)).sum())
        print(f"  LR decision flips card vs native "
              f"({kw or 'no min_range'}): {flips} of {got.size} cells "
              f"({int(np.isnan(want).sum())} cells at the default on the "
              f"native route)", flush=True)
    print(f"  LR gradient on the native route: median "
          f"{float(np.median(native_lr)):.6g} K/m (the field's lapse rate "
          "-0.0065)", flush=True)

    # -- call times: numpy in and out, wall clock; device time from
    # torch.profiler, the kernels apart from the host<->device copies --
    for name, (fn, _, args) in calls.items():
        run = on_card(dev, lambda: fn(*args))
        times = [timed(run)[1] for _ in range(3)]
        # a trace may come back without device events: take a second one
        by_name = (device_ms(run, reps=3, by_kernel=True)
                   or device_ms(run, reps=3, by_kernel=True))
        copy_ms = sum(t for k, t in by_name.items() if "memcpy" in k.lower())
        kern_ms = sum(by_name.values()) - copy_ms
        dev_txt = (f"device: kernels {kern_ms:.3f} ms, copies {copy_ms:.3f} "
                   "ms" if by_name else "device time not measured")
        print(f"  {name}: median call {statistics.median(times) * 1e3:.3f} "
              f"ms over 3 ({', '.join(f'{t * 1e3:.3f}' for t in times)} ms),"
              f" {dev_txt}; host route {host_s[name] * 1e3:.3f} ms (one "
              "call)", flush=True)
    print(f"  LR plain route on the host (K1's plain version) "
          f"{plain_s * 1e3:.3f} ms (one call)", flush=True)
    return k1_entry


# -- phase 11: the rest of gridpp's numpy API --------------------------------
N_TIMES = 24             # (obs, forecast) pairs a station; window's leads
N_MEMBERS = 10
SLICE_CUT = 256          # the cut on which the card meets the host route
SMART_CUT = (128, 128)   # smart's cut, onto itself
LDC_HOST_CUT = 500       # LDC's host route is timed on this cut
MEPS_CUT = (130, 110)    # the MEPS rows and columns over the 256^2 cut
SCORE_HS = (7, 25)
N_KNOTS = 1000
# rtol, atol of the card route against the host route: the parity tests'
# bars (tests/test_torch_api_*.py); None: equal
SLICE_BAR = (1e-5, 1e-5)
PA_BAR = (1e-5, 1e-2)     # pressures in Pa (~1e5)
# LDC (ROADMAP F11): where a pair of small rho sits between two curve
# points, the interpolation divides by their tiny quantile step, and any
# two routes whose rho or sums differ in the last bits part past
# tests/test_ldc.py:155's bar there (gridpp_tpu's own two routes too).
# The card's rho may differ from the CPU's by LDC_RHO_ATOL (exp's last
# bits; 16 ulp at 1); on the card's rho, the CPU's device route meets the
# card at the bar on every cell. The two host routes, the device route on
# the CPU and the native one, part on some cells of these inputs; the card
# route may part from the native route on at most LDC_NATIVE_FACTOR times
# as many
LDC_BAR = (2e-5, 2e-5)
LDC_RHO_ATOL = 1e-6
LDC_NATIVE_FACTOR = 2.0
SCORE_BAR = (K1_RTOL, K1_ATOL)


def precip(rng, shape, dry=0.6):
    """Seeded precipitation in mm: gamma(0.8, 3) amounts, a share dry."""
    x = rng.gamma(0.8, 3.0, shape).astype(np.float32)
    x[rng.random(shape) < dry] = 0.0
    return x


def max_diff(got, want):
    """(max |got - want| where both are finite, NaN in the same places)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = bool(np.array_equal(np.isnan(got), np.isnan(want)))
    d = np.abs(got - want)
    d = d[np.isfinite(d)]
    return (float(d.max()) if d.size else 0.0), same


def agrees(got, want, bar):
    """got and want alike: NaN in the same places, and equal (bar None) or
    within (rtol, atol) elsewhere."""
    if bar is None:
        return bool(np.array_equal(got, want, equal_nan=True))
    return bool(np.allclose(got, want, rtol=bar[0], atol=bar[1],
                            equal_nan=True)) and max_diff(got, want)[1]


def bar_text(bar):
    return "equal" if bar is None else f"rtol {bar[0]}, atol {bar[1]}"


def past_bar(got, want, bar):
    """The cells of got past (rtol, atol) of want."""
    return int((~np.isclose(got, want, rtol=bar[0], atol=bar[1],
                            equal_nan=True)).sum())


class RhoOn:
    """A structure whose corr_background_torch is evaluated on dev and
    handed back on the caller's device: the CPU's route then runs on the
    card's rho bits. max_diff: the largest |rho on dev - rho on the
    caller's device| it saw."""

    def __init__(self, structure, dev):
        self.structure, self.dev, self.max_diff = structure, dev, 0.0

    def __getattr__(self, name):
        return getattr(self.structure, name)

    def corr_background_torch(self, p1, p2):
        own = self.structure.corr_background_torch(p1, p2)
        rho = self.structure.corr_background_torch(
            *({k: v.to(self.dev) for k, v in p.items()} for p in (p1, p2)))
        rho = rho.to(own.device)
        if rho.numel():
            self.max_diff = max(self.max_diff,
                                float((rho - own).abs().max()))
        return rho


def ldc_on_cpu(args, rho_dev=None):
    """local_distribution_correction's device route on the CPU: the card
    route's algorithm, on the CPU's rho, or on rho_dev's (RhoOn). Returns
    (out, max |rho_dev's rho - the CPU's|, 0 without rho_dev)."""
    from gridpp_tpu_torch.api import ldc as tldc
    from gridpp_tpu_torch.api import oi as toi
    grid, bg, pts, pobs, pbg, structure, minq, maxq, min_points = args
    if rho_dev is not None:
        structure = RhoOn(structure, rho_dev)
    bpoints = grid.to_points()
    cand, mask = toi._candidates(bpoints, pts, structure.localization_np(
        bpoints.lats, bpoints.lons), 0)
    out = tldc._ldc_device(
        bpoints, pts, structure, bg.reshape(-1), cand, mask, pobs, pbg, minq,
        maxq, min_points, torch.device("cpu")).reshape(bg.shape)
    return out, getattr(structure, "max_diff", 0.0)


def smart_margins(grid, structure, num, cells):
    """For smart's output cells (flat indices) on grid onto itself: the
    gap between the num-th and the (num+1)-th highest rho of each cell's
    candidates on the host route (the CPU's f32 structure), relative to
    the num-th: the margin its selection has."""
    from gridpp_tpu_torch.api import oi as toi
    from gridpp_tpu_torch.api import search as tsearch
    pts = grid.to_points()
    cand, mask = toi._candidates(pts, pts, structure.localization_np(
        pts.lats, pts.lons), num)
    cpu = torch.device("cpu")
    f = tsearch._field_tensors(pts, structure, cpu)
    rows = torch.as_tensor(np.asarray(cells))
    c = torch.as_tensor(cand[cells]).long()
    rho = structure.corr_torch({k: v[rows, None] for k, v in f.items()},
                               {k: v[c] for k, v in f.items()})
    rho = torch.where(torch.as_tensor(mask[cells]), rho, -torch.inf)
    top = torch.sort(rho, dim=1, descending=True).values
    return ((top[:, num - 1] - top[:, num]) / top[:, num - 1]).numpy()


def score_k1_entry(gt, stencil, planes, h, launches):
    """The `kernels` line's entry of K1 on neighbourhood_score's path at
    halfwidth h: one launch on the (4, Y, X) indicator planes, against its
    plain version and avg_pool2d (the planes hold no NaN), with its
    bound."""
    mean = int(gt.Mean)
    k = 2 * h + 1

    def card():
        return stencil.neighbourhood_mean_cuda(planes, h, h, mean)

    def plain():
        return stencil.neighbourhood_mean_plain(planes, h, h, mean)

    def library():
        return F.avg_pool2d(planes[:, None], k, 1, h,
                            count_include_pad=False)[:, 0]

    ok, err = compare(card(), plain(), SCORE_BAR)
    check(ok, f"neighbourhood_score's K1, {tuple(planes.shape)} h={h}, vs "
              f"plain: max|d|={err:.3g}")
    ok, e = compare(card(), library(), SCORE_BAR)
    check(ok, f"neighbourhood_score's K1 h={h}: the library call computes "
              f"the same function (max|d|={e:.3g})")
    entry = {
        "name": f"neighbourhood_mean_cuda (neighbourhood_score: 4 "
                f"indicator planes, Mean h={h})",
        "route": "cuda",
        "source": "gridpp_tpu_torch/csrc/neighbourhood_mean.cu",
        "replaces": f"{PALLAS}:301",
        "launches": launches, "max_abs_err": err, "ms": event_ms(card),
        "cold_ms": cold_ms(lambda a: stencil.neighbourhood_mean_cuda(
            a, h, h, mean), planes)}
    # one launch a call, back to back: a trace far below the event time
    # is a partial one, taken again (and not measured if it stays so)
    entry.update(device_ms=device_ms(card, at_least=0.5 * entry["ms"]),
                 plain_ms=event_ms(plain, reps=5),
                 library_ms=event_ms(library))
    entry["bound_ms"], entry["bound_by"] = bound_ms("K1", planes.shape, h)
    dev_ms = entry["device_ms"]
    print(f"  K1 on neighbourhood_score's planes {tuple(planes.shape)}, h={h}"
          f": kernel {entry['ms']:.4f} ms, cold {entry['cold_ms']:.4f} ms "
          "(device only "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
          f"plain {entry['plain_ms']:.4f} ms, library call "
          f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}), {entry['bound_ms'] / entry['ms']:.3f} of "
          "the bound", flush=True)
    return entry


def slice_data(gt, lats, lons, plats, plons, rng):
    """Phase 11's objects and fields on the grid (lats, lons), with its
    points at (plats, plons) and the MEPS grid over the same domain."""
    elev, laf = terrain(lats, lons, fine=True)
    p = plats.size
    grid = gt.Grid(lats, lons, elev, laf)
    pidx = grid.nearest_map(plats, plons)
    pts = gt.Points(plats, plons,
                    elev.reshape(-1)[pidx] + rng.normal(0, 20, p),
                    laf.reshape(-1)[pidx])
    shape = lats.shape
    temp = (288 - 0.0065 * elev + rng.normal(0, 2, shape)).astype(
        np.float32)
    slats, slons = np.meshgrid(np.linspace(55, 62, MEPS_SHAPE[0]),
                               np.linspace(5, 12, MEPS_SHAPE[1]),
                               indexing="ij")
    selev, slaf = terrain(slats, slons, fine=False)
    # smart's grid: MEPS's published size and spacing (~2.5 km: 0.0225 deg
    # of latitude, 0.045 deg of longitude, 2.5 km at 60N), 52-73N 0-33E
    mlats, mlons = np.meshgrid(52 + 0.0225 * np.arange(MEPS_SHAPE[0]),
                               0.045 * np.arange(MEPS_SHAPE[1]),
                               indexing="ij")
    melev, mlaf = terrain(mlats, mlons, fine=False)
    d = dict(
        grid=grid, pts=pts, elev=elev, laf=laf, temp=temp,
        fc=precip(rng, shape), obs=precip(rng, (p,)),
        pobs=precip(rng, (N_TIMES, p)), pbg=precip(rng, (N_TIMES, p)),
        hourly=precip(rng, (lats.size, N_TIMES)),
        meps=gt.Grid(slats, slons, selev, slaf),
        smart=gt.Grid(mlats, mlons, melev, mlaf),
        mtemp=(288 - 0.0065 * melev + rng.normal(0, 2, MEPS_SHAPE)).astype(
            np.float32),
        ens=[precip(rng, MEPS_SHAPE + (N_MEMBERS,)) for _ in range(3)],
        thr=np.full(shape, 1.0, np.float32),
        rh=rng.uniform(0.05, 1.0, shape).astype(np.float32),
        td=(temp - rng.uniform(0, 10, shape)).astype(np.float32),
        ps=(101325 * np.exp(-elev / 8000.0)).astype(np.float32),
        u=rng.normal(0, 6, shape).astype(np.float32),
        v=rng.normal(0, 6, shape).astype(np.float32),
        knots=gt.Points(rng.uniform(55, 62, N_KNOTS),
                        rng.uniform(5, 12, N_KNOTS), np.zeros(N_KNOTS),
                        np.zeros(N_KNOTS)))
    d["zeros"] = np.zeros(shape, np.float32)
    d["no_td"] = np.full(shape, np.nan, np.float32)
    return d


def slice_cut(gt, d, m):
    """d on the grid's first m x m cells, the points inside them, the MEPS
    cut over them, and smart's MEPS cut."""
    lats, lons = d["grid"].get_lats(), d["grid"].get_lons()
    pts = d["pts"]
    inside = ((pts.get_lats() <= lats[m - 1, 0])
              & (pts.get_lons() <= lons[0, m - 1]))
    meps = d["meps"]

    def sub(g, shape):
        return gt.Grid(*(a[:shape[0], :shape[1]] for a in (
            g.get_lats(), g.get_lons(), g.get_elevs(), g.get_lafs())))

    c = {k: v[:m, :m] for k, v in d.items()
         if isinstance(v, np.ndarray) and v.shape == lats.shape}
    c.update(
        grid=sub(d["grid"], (m, m)),
        pts=gt.Points(*(a[inside] for a in (
            pts.get_lats(), pts.get_lons(), pts.get_elevs(),
            pts.get_lafs()))),
        obs=d["obs"][inside], pobs=d["pobs"][:, inside],
        pbg=d["pbg"][:, inside], hourly=d["hourly"][:m * m],
        meps=sub(meps, MEPS_CUT),
        ens=[e[:MEPS_CUT[0], :MEPS_CUT[1]] for e in d["ens"]],
        smart=sub(d["smart"], SMART_CUT),
        mtemp=d["mtemp"][:SMART_CUT[0], :SMART_CUT[1]], knots=d["knots"])
    return c


def slice_calls(gt, d, structures):
    """name -> (api module, function name, args, bar) on the data d."""
    from gridpp_tpu_torch.api import diagnostics as tdiag
    from gridpp_tpu_torch.api import ldc as tldc
    from gridpp_tpu_torch.api import masking as tmask
    from gridpp_tpu_torch.api import search as tsearch
    from gridpp_tpu_torch.api import verif as tverif
    from gridpp_tpu_torch.api import window_api as twin
    b5, b10, b25 = structures
    calls = {
        f"neighbourhood_score h={h}": (
            tverif, "neighbourhood_score",
            (d["grid"], d["pts"], d["fc"], d["obs"], h, gt.Ets, 1.0),
            SCORE_BAR) for h in SCORE_HS}
    calls.update({
        "neighbourhood_search h=7": (
            tsearch, "neighbourhood_search",
            (d["temp"], d["laf"], 7, 0.8, 1.0, 0.1), SLICE_BAR),
        "local_distribution_correction": (
            tldc, "local_distribution_correction",
            (d["grid"], d["fc"], d["pts"], d["pobs"], d["pbg"], b10, 0.1,
             0.9, 5), LDC_BAR),
        "window Sum 3 before": (twin, "window",
                                (d["hourly"], 3, gt.Sum, True), SLICE_BAR),
        "window Mean 5": (twin, "window", (d["hourly"], 5, gt.Mean),
                          SLICE_BAR),
        "window Max 5": (twin, "window", (d["hourly"], 5, gt.Max), None),
        "downscale_probability": (
            tmask, "downscale_probability",
            (d["meps"], d["grid"], d["ens"][0], d["thr"], gt.Geq), None),
        "mask_threshold_downscale_consensus": (
            tmask, "mask_threshold_downscale_consensus",
            (d["meps"], d["grid"], *d["ens"], d["thr"], gt.Geq, gt.Mean),
            SLICE_BAR),
        "dewpoint": (tdiag, "dewpoint", (d["temp"], d["rh"]), SLICE_BAR),
        "relative_humidity": (tdiag, "relative_humidity",
                              (d["temp"], d["td"]), SLICE_BAR),
        "wetbulb": (tdiag, "wetbulb", (d["temp"], d["ps"], d["rh"]),
                    SLICE_BAR),
        "pressure": (tdiag, "pressure",
                     (d["elev"], d["zeros"], d["ps"], d["temp"]), PA_BAR),
        "sea_level_pressure": (
            tdiag, "sea_level_pressure",
            (d["ps"], d["elev"], d["temp"], d["rh"], d["no_td"]), PA_BAR),
        "qnh": (tdiag, "qnh", (d["ps"], d["elev"]), PA_BAR),
        "wind_speed": (tdiag, "wind_speed", (d["u"], d["v"]), SLICE_BAR),
        "wind_direction": (tdiag, "wind_direction", (d["u"], d["v"]),
                           SLICE_BAR),
        "smart": (tsearch, "smart",
                  (d["smart"], d["smart"], d["mtemp"], 5, b5), SLICE_BAR),
        "staticcorr_points": (tsearch, "staticcorr_points",
                              (d["pts"], d["knots"], b25, 20), SLICE_BAR),
    })
    return calls


def api_slice_phase(gt, dev, lats, lons, plats, plons):
    """Phase 11: the rest of gridpp's numpy API through the port's module
    functions on the card, each held against its host route on a 256^2
    cut, timed beside it at full size. Returns the `kernels` line's
    entries of K1 on neighbourhood_score's path, with their launches in the
    phase's driving calls."""
    from gridpp_tpu_torch.api import ldc as tldc
    from gridpp_tpu_torch.api import oi as toi
    from gridpp_tpu_torch.api import verif as tverif
    from gridpp_tpu_torch.ops import search as search_ops
    from gridpp_tpu_torch.ops import stencil

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    d = slice_data(gt, lats, lons, plats, plons, rng)
    # BarnesStructure(5 km): smart's; 10 km: LDC's (the benchmark's);
    # 25 km: staticcorr_points' (~80 knots in radius, so max_points=20 cuts)
    structures = tuple(gt.BarnesStructure(h) for h in (5000.0, 10000.0,
                                                       25000.0))
    n, p = lats.shape[0], plats.size
    print(f"  data {time.perf_counter() - t0:.3f} s: grid {n}x{n}, {p} "
          f"points, {N_TIMES} times, MEPS {MEPS_SHAPE} x {N_MEMBERS} "
          f"members, {N_KNOTS} knots; precipitation "
          f"{float((d['fc'] == 0).mean()):.3f} dry", flush=True)

    # the host's set-up, once per network: LDC's candidate lists, smart's
    bpoints = d["grid"].to_points()
    loc = structures[1].localization_np(bpoints.lats, bpoints.lons)
    (cand, mask), secs = timed(lambda: toi._candidates(
        bpoints, d["pts"], loc, 0))
    k = cand.shape[1]
    block = tldc.block_rows(k, N_TIMES)
    print(f"  LDC candidates: {secs:.3f} s on the host; K={k} (mean "
          f"{float(mask.sum(1).mean()):.1f} in radius), K*T={k * N_TIMES}, "
          f"block {block} gridpoints, {-(-cand.shape[0] // block)} blocks",
          flush=True)
    mpoints = d["smart"].to_points()
    (scand, _), secs = timed(lambda: toi._candidates(
        mpoints, mpoints, structures[0].localization_np(
            mpoints.lats, mpoints.lons), 5))
    print(f"  smart candidates: {secs:.3f} s on the host; K={scand.shape[1]}"
          f" (padded)", flush=True)
    band = search_ops.band_rows((n, n), 7)
    print(f"  neighbourhood_search h=7: bands of {band} rows "
          f"({-(-n // band)} bands)", flush=True)
    del cand, mask, scand

    calls = slice_calls(gt, d, structures)
    wrappers = (stencil.neighbourhood_mean_cuda,
                stencil.neighbourhood_minmax_cuda,
                stencil.neighbourhood_var_cuda,
                stencil.neighbourhood_quantile_fast_cuda,
                stencil.neighbourhood_members_cuda)
    torch.cuda.empty_cache()
    for w in wrappers:
        w.launches = 0
    # -- the driving calls, counts from 0 --
    card, peak, k1 = {}, {}, {}
    for name, (mod, fn, args, _) in calls.items():
        torch.cuda.reset_peak_memory_stats()
        before = stencil.neighbourhood_mean_cuda.launches
        card[name], secs = timed(on_card(dev, lambda: getattr(mod, fn)(
            *args)))
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        k1[name] = stencil.neighbourhood_mean_cuda.launches - before
        out = card[name]
        check(isinstance(out, np.ndarray) and out.dtype == np.float32
              and bool(np.isfinite(out).any()),
              f"{name}: numpy {out.shape} f32 from the card, first call "
              f"{secs * 1e3:.3f} ms, peak device memory {peak[name]:.3f} GB")
    launches = {w.__name__: w.launches for w in wrappers}
    score_launches = {h: k1[f"neighbourhood_score h={h}"] for h in SCORE_HS}
    check(all(v == 1 for v in score_launches.values())
          and launches["neighbourhood_mean_cuda"] == len(SCORE_HS)
          and sum(launches.values()) == len(SCORE_HS),
          f"the phase's kernel launches: one K1 a neighbourhood_score call, "
          f"no other kernel ({launches})")
    print(f"  phase peak device memory {max(peak.values()):.3f} GB "
          f"({max(peak, key=peak.get)})", flush=True)
    for h in SCORE_HS:
        s = card[f"neighbourhood_score h={h}"]
        print(f"  neighbourhood_score h={h} (Ets): median "
              f"{float(np.nanmedian(s)):.4f}, {float(np.isnan(s).mean()):.4f}"
              " of cells NaN", flush=True)

    # -- each call against the host route on the cut --
    cut = slice_calls(gt, slice_cut(gt, d, SLICE_CUT), structures)
    for name, (mod, fn, args, bar) in cut.items():
        got = on_card(dev, lambda: getattr(mod, fn)(*args))()
        want = getattr(gt, fn)(*args)
        e, same_nan = max_diff(got, want)
        if name == "local_distribution_correction":
            plain, _ = ldc_on_cpu(args)
            fed, rho_d = ldc_on_cpu(args, dev)
            n_host = past_bar(plain, want, bar)
            n_cpu, n_native = past_bar(got, plain, bar), past_bar(got, want,
                                                                  bar)
            check(rho_d <= LDC_RHO_ATOL and got.shape == fed.shape
                  and agrees(got, fed, bar),
                  f"{name}, {SLICE_CUT}^2 cut ({bar_text(bar)}): the card's "
                  f"rho within {LDC_RHO_ATOL} of the CPU's (max|d|="
                  f"{rho_d:.3g}); on the card's rho the CPU's device route "
                  f"meets the card (max|d|={max_diff(got, fed)[0]:.3g}, "
                  f"{past_bar(got, fed, bar)} cells past); on its own rho it "
                  f"parts from the card on {n_cpu} cells (max|d|="
                  f"{max_diff(got, plain)[0]:.3g}; ROADMAP F11)")
            check(n_native <= LDC_NATIVE_FACTOR * n_host and same_nan
                  and got.shape == want.shape,
                  f"{name}, {SLICE_CUT}^2 cut ({bar_text(bar)}; ROADMAP "
                  f"F11): the two host routes part on {n_host} cells; the "
                  f"card parts from the native route on {n_native} (max|d|="
                  f"{e:.3g}, at most {LDC_NATIVE_FACTOR}x)")
            continue
        past = ("" if bar is None else
                f", {past_bar(got, want, bar)} cells past (rtol, atol)")
        check(got.shape == want.shape and agrees(got, want, bar),
              f"{name}, {SLICE_CUT}^2 cut: card vs host route max|d|="
              f"{e:.3g}, NaN alike {same_nan}{past} ({bar_text(bar)})")

    # -- K1 on neighbourhood_score's path --
    planes = torch.as_tensor(tverif.indicator_planes(
        d["grid"], d["pts"], d["fc"], d["obs"], 1.0), device=dev)
    entries = [score_k1_entry(gt, stencil, planes, h, score_launches[h])
               for h in SCORE_HS]
    del planes

    # -- call times: numpy in and out, wall clock; device time from
    # torch.profiler, the kernels apart from the copies; the host route
    # (the top-level function) once, at full size --
    for name, (mod, fn, args, bar) in calls.items():
        run = on_card(dev, lambda: getattr(mod, fn)(*args))
        times = [timed(run)[1] for _ in range(3)]
        by_name = (device_ms(run, reps=1, by_kernel=True)
                   or device_ms(run, reps=1, by_kernel=True))
        copy_ms = sum(t for key, t in by_name.items()
                      if "memcpy" in key.lower())
        kern_ms = sum(by_name.values()) - copy_ms
        dev_txt = (f"device: kernels {kern_ms:.3f} ms, copies {copy_ms:.3f} "
                   "ms" if by_name else "device time not measured")
        if name == "local_distribution_correction":
            # the native route takes minutes at 2000^2: timed on a cut
            m = LDC_HOST_CUT
            host_args = slice_calls(gt, slice_cut(gt, d, m),
                                    structures)[name][2]
            _, host_s = timed(lambda: getattr(gt, fn)(*host_args))
            versus = f"host route {host_s * 1e3:.3f} ms on the {m}^2 cut"
        else:
            want, host_s = timed(lambda: getattr(gt, fn)(*args))
            e, same_nan = max_diff(card[name], want)
            past = ("" if bar is None else
                    f", {past_bar(card[name], want, bar)} cells past the "
                    "bar")
            versus = (f"host route {host_s * 1e3:.3f} ms; card vs host "
                      f"route at full size max|d|={e:.3g}, NaN alike "
                      f"{same_nan}{past}")
            apart = np.nonzero(~np.isclose(card[name], want, rtol=1e-5,
                                           atol=1e-5, equal_nan=True)
                               .ravel())[0]
            if name == "smart" and apart.size:
                # a cell apart: its selection's margin on the host route
                print(f"  smart: the {apart.size} cells apart, their "
                      "selection margins (rho_5 - rho_6) / rho_5: "
                      f"{smart_margins(args[0], args[4], args[3], apart[:10])}",
                      flush=True)
        print(f"  {name}: median call {statistics.median(times) * 1e3:.3f} "
              f"ms over 3 ({', '.join(f'{t * 1e3:.3f}' for t in times)} ms),"
              f" {dev_txt}; {versus} (one call)", flush=True)

    # -- the host-only functions (host code in both packages), once --
    holes = d["temp"].copy()
    holes[rng.random(holes.shape) < 0.3] = np.nan
    ptemp = (d["temp"].reshape(-1)[d["grid"].nearest_map(plats, plons)]
             + rng.normal(0, 1, p)).astype(np.float32)
    levels = rng.uniform(0, 1, lats.shape).astype(np.float32)
    host_only = {
        "gridding Mean r=5 km": lambda: gt.gridding(
            d["grid"], d["pts"], d["obs"], 5000.0, 0, gt.Mean),
        "gridding_nearest Mean": lambda: gt.gridding_nearest(
            d["grid"], d["pts"], d["obs"], 1, gt.Mean),
        "count r=5 km": lambda: gt.count(d["pts"], d["grid"], 5000.0),
        "distance": lambda: gt.distance(d["pts"], d["grid"], 1),
        "fill r=3 km": lambda: gt.fill(d["grid"], d["temp"], d["pts"],
                                       np.full(p, 3000.0), 273.15, False),
        "fill_missing": lambda: gt.fill_missing(holes),
        "doping_square h=2": lambda: gt.doping_square(
            d["grid"], d["temp"], d["pts"], ptemp, np.full(p, 2)),
        "doping_circle r=3 km": lambda: gt.doping_circle(
            d["grid"], d["temp"], d["pts"], ptemp, np.full(p, 3000.0)),
        "gamma_inv": lambda: gt.gamma_inv(levels, np.full(levels.shape, 0.8),
                                          np.full(levels.shape, 3.0)),
    }
    for name, fn in host_only.items():
        out, secs = timed(fn)
        check(isinstance(out, np.ndarray) and out.dtype == np.float32
              and bool(np.isfinite(out).any()),
              f"{name}: host only, {secs * 1e3:.3f} ms (one call), numpy "
              f"{out.shape} f32")
    return entries


# -- phases 12 and 13: the parallel layer and the command-line client --------
STEP_RTOL, STEP_ATOL = 2e-5, 2e-4   # tests/test_distributed.py:80
PAR_H, PAR_RANKS, PAR_BLOCK, PAR_REPS = 7, 4, 4096, 3
CLI_H = 7
# the CLI's output variables: name -> the statistic of its neighbourhood
# calibrator (None: bilinear alone)
CLI_VARS = {"t_bilinear": None, "t_mean": "mean", "t_max": "max",
            "t_std": "std"}
# the -c oi cut: its size, its leads (the calibrator's kriging is host
# numpy, ~5.5 s a lead at 256^2) and the OI calibrator's options
CLI_OI_CUT, CLI_OI_LEADS = 256, 2
CLI_OI_OPTS = ["d=30000", "transform=boxcox", "lambda=0.5"]


def path_entry(stencil, label, k, x, h, stat, launches, library=None):
    """The `kernels` line's entry of kernel k (K1, K2 or K3) on a path's
    tensor x at halfwidth h: held against its plain version at the
    kernel's bar, timed beside it and, where one PyTorch call computes the
    same function on x (library), beside that, with its bound."""
    wrapper, plain_fn, tol, src = {
        "K1": (stencil.neighbourhood_mean_cuda,
               stencil.neighbourhood_mean_plain, (K1_RTOL, K1_ATOL),
               "neighbourhood_mean"),
        "K2": (stencil.neighbourhood_minmax_cuda,
               stencil.neighbourhood_minmax_plain, None,
               "neighbourhood_minmax"),
        "K3": (stencil.neighbourhood_var_cuda,
               stencil.neighbourhood_var_plain, (K3_RTOL, K3_ATOL),
               "neighbourhood_var")}[k]
    line = {"K1": 301, "K2": 364, "K3": 330}[k]

    def card():
        return wrapper(x, h, h, stat)

    def plain():
        return plain_fn(x, h, h, stat)

    ok, err = compare(card(), plain(), tol)
    check(ok, f"{k} on {label} {tuple(x.shape)} h={h} vs plain: "
              f"max|d|={err:.3g}")
    if library is not None:
        ok, e = compare(card(), library(), (K1_RTOL, K1_ATOL))
        check(ok, f"{k} on {label}: the library call computes the same "
                  f"function (max|d|={e:.3g})")
    entry = {"name": f"{wrapper.__name__} ({label})", "route": "cuda",
             "source": f"gridpp_tpu_torch/csrc/{src}.cu",
             "replaces": f"{PALLAS}:{line}", "launches": launches,
             "max_abs_err": err, "ms": event_ms(card),
             "cold_ms": cold_ms(lambda a: wrapper(a, h, h, stat), x)}
    entry.update(device_ms=device_ms(card, at_least=0.5 * entry["ms"]),
                 plain_ms=event_ms(plain, reps=5),
                 library_ms=None if library is None else event_ms(library))
    entry["bound_ms"], entry["bound_by"] = bound_ms(k, x.shape, h)
    dev_ms, lib = entry["device_ms"], entry["library_ms"]
    print(f"  {k} on {label} {tuple(x.shape)}, h={h}: kernel "
          f"{entry['ms']:.4f} ms, cold {entry['cold_ms']:.4f} ms (device only "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
          f"plain {entry['plain_ms']:.4f} ms, library call "
          f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
          f"{entry['bound_ms'] / entry['ms']:.3f} of the bound", flush=True)
    return entry


def step_problem():
    """Phase 5's problem as the distributed step takes it: (structure,
    background (Y, X), grid-point fields (Y, X), obs fields (P,), pobs,
    pback, ratios), numpy."""
    import gridpp_tpu_torch as gt
    from gridpp_tpu_torch.api.oi import _origin, _resolved_fields
    lats, lons, plats, plons, background, noise = bench_problem()
    p = plats.size
    grid = gt.Grid(lats, lons)
    points = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    structure = gt.BarnesStructure(10000.0)
    pback = background.reshape(-1)[grid.nearest_map(points.lats,
                                                    points.lons)]
    pobs = (pback + noise).astype(np.float32)
    bpoints = grid.to_points()
    origin = _origin(bpoints)
    p1 = {k: np.asarray(v, np.float32).reshape(background.shape)
          for k, v in _resolved_fields(bpoints, structure, origin).items()}
    obs = {k: np.asarray(v, np.float32)
           for k, v in _resolved_fields(points, structure, origin).items()}
    return (structure, background, p1, obs, pobs, pback,
            np.full(p, 0.1, np.float32))


def run_step(mesh, prob):
    """make_distributed_step (Mean h=7, max_points 10) on this rank's block
    of prob: PAR_REPS steps, each timed on the host clock up to a
    synchronised card, then its exchange and stencil once alone (the OI's
    share is the rest of the median step). Returns (the analysis block,
    the step seconds, the parts' seconds, K1's launches in the steps, the
    padded tile)."""
    from gridpp_tpu_torch.constants import Statistic
    from gridpp_tpu_torch.ops import neighbourhood as nops
    from gridpp_tpu_torch.ops import stencil
    from gridpp_tpu_torch.parallel import distributed as gdist
    from gridpp_tpu_torch.parallel.halo import halo_exchange_2d

    structure, background, p1, obs, pobs, pback, ratios = prob
    ys, xs = mesh.block_slices(background.shape)
    bg = gdist.global_field(background[ys, xs], mesh)
    tiles = {k: gdist.global_field(v[ys, xs], mesh) for k, v in p1.items()}
    rest = ({k: gdist.replicate(v, mesh) for k, v in obs.items()},
            gdist.replicate(pobs, mesh), gdist.replicate(pback, mesh),
            gdist.replicate(ratios, mesh))
    mean = int(Statistic.Mean)
    step = gdist.make_distributed_step(mesh, structure, PAR_H, mean, 10,
                                       True, tuple(p1), PAR_BLOCK)
    stencil.neighbourhood_mean_cuda.launches = 0
    times = []
    for _ in range(PAR_REPS):
        out, secs = timed(lambda: step(bg, tiles, *rest))
        times.append(secs)
    launches = stencil.neighbourhood_mean_cuda.launches
    padded, t_ex = timed(lambda: halo_exchange_2d(bg, PAR_H, mesh))
    _, t_st = timed(lambda: nops.neighbourhood(padded, PAR_H, mean)[
        PAR_H:-PAR_H, PAR_H:-PAR_H].reshape(-1))
    t_oi = statistics.median(times) - t_ex - t_st
    return out, times, (t_ex, t_st, t_oi), launches, padded


def parallel_rank():
    """Phase 12 (b) and (c) on one of PAR_RANKS gloo ranks, every rank's
    tiles on cuda:0: the distributed step on make_mesh(PAR_RANKS), then
    sharded_neighbourhood Mean, Max and Std (on the anomaly) h=7. Returns
    this rank's times, launches and peak memory, and on rank 0 the
    gathered fields."""
    import torch.distributed as dist

    import gridpp_tpu_torch as gt
    from gridpp_tpu_torch.ops import stencil
    from gridpp_tpu_torch.parallel import make_mesh, sharded_neighbourhood
    from gridpp_tpu_torch.parallel import distributed as gdist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(PAR_RANKS)
    prob = step_problem()
    torch.cuda.reset_peak_memory_stats()
    out, times, parts, k1_step, _ = run_step(mesh, prob)
    analysis = gdist.gather_to_host(out, mesh)
    ys, xs = mesh.block_slices(prob[1].shape)
    tile = gdist.global_field(prob[1][ys, xs], mesh)
    sharded = {}
    for w in (stencil.neighbourhood_mean_cuda,
              stencil.neighbourhood_minmax_cuda,
              stencil.neighbourhood_var_cuda):
        w.launches = 0
    for stat in (int(gt.Mean), int(gt.Max), int(gt.Std)):
        x = tile - 280.0 if stat == int(gt.Std) else tile
        sharded[stat] = gdist.gather_to_host(
            sharded_neighbourhood(mesh, PAR_H, stat)(x), mesh)
    return {"device": str(mesh.device), "backend": dist.get_backend(),
            "staged": mesh.staged(), "mesh": mesh.ranks.shape,
            "times": times, "parts": parts, "k1_step": k1_step,
            "sharded_launches": [w.launches for w in (
                stencil.neighbourhood_mean_cuda,
                stencil.neighbourhood_minmax_cuda,
                stencil.neighbourhood_var_cuda)],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "analysis": analysis if dist.get_rank() == 0 else None,
            "sharded": sharded if dist.get_rank() == 0 else None}


def report_step(label, times, parts):
    print(f"  {label}: step median {statistics.median(times):.3f} s of "
          f"{len(times)} ({', '.join(f'{t:.3f}' for t in times)} s); "
          f"exchange {parts[0] * 1e3:.3f} ms, stencil "
          f"{parts[1] * 1e3:.3f} ms (each alone), OI the rest, "
          f"{parts[2]:.3f} s", flush=True)


def parallel_phase(gt, dev):
    """Phase 12: the parallel layer at phase 5's size. (a) one NCCL rank:
    the distributed step against the same arithmetic on one tensor, and K1
    on its padded tile; (b) PAR_RANKS gloo ranks on this card: their
    gathered analysis against (a); (c) the sharded stencil on (b)'s mesh
    against the whole grid. Returns the `kernels` line's entries."""
    import socket

    import torch.distributed as dist

    from gridpp_tpu_torch.ops import neighbourhood as nops
    from gridpp_tpu_torch.ops import stencil
    from gridpp_tpu_torch.ops.oi import oi_dense_sweep
    from gridpp_tpu_torch.parallel import distributed as gdist
    from gridpp_tpu_torch.parallel.dryrun import run_ranks

    mean, mx, std = int(gt.Mean), int(gt.Max), int(gt.Std)
    prob, secs = timed(step_problem)
    structure, background, p1, obs, pobs, pback, ratios = prob
    print(f"  data {secs:.3f} s: {background.shape}, {pobs.size} obs, "
          f"BarnesStructure(10 km), max_points 10, Mean h={PAR_H}, OI "
          f"blocks of {PAR_BLOCK} gridpoints", flush=True)

    # -- (a) one NCCL rank --
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    check(gdist.initialize(f"localhost:{port}", 1, 0) is False
          and dist.get_backend() == "nccl",
          "initialize(): a one-rank NCCL group, not distributed")
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    check(float(one) == 1.0, "NCCL all_reduce on the one-rank group")
    mesh = gdist.global_mesh()
    check(mesh.ranks.shape == (1, 1) and mesh.device == dev,
          f"global_mesh(): (1, 1) on {mesh.device}")
    torch.cuda.reset_peak_memory_stats()
    out_a, times, parts, k1_launches, padded = run_step(mesh, prob)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(k1_launches == PAR_REPS,
          f"K1 launched once a step ({k1_launches} in {PAR_REPS} steps)")
    report_step(f"one NCCL rank, {background.shape}", times, parts)
    bg = torch.as_tensor(background, device=dev)
    flat = nops.neighbourhood(bg, PAR_H, mean).reshape(-1)
    ref, secs = timed(lambda: oi_dense_sweep(
        structure, {k: torch.as_tensor(v.reshape(-1), device=dev)
                    for k, v in p1.items()},
        {k: torch.as_tensor(v, device=dev) for k, v in obs.items()}, flat,
        torch.ones_like(flat), torch.as_tensor(pobs, device=dev),
        torch.as_tensor(pback, device=dev),
        torch.as_tensor(ratios, device=dev), 10, True, PAR_BLOCK)[0])
    ref = ref.reshape(bg.shape)
    ok, err = compare(out_a, ref, (STEP_RTOL, STEP_ATOL))
    check(ok and bool(torch.isfinite(out_a).all()),
          f"one rank: the step == whole-grid ops.neighbourhood + "
          f"oi_dense_sweep ({secs:.3f} s) at rtol {STEP_RTOL}, atol "
          f"{STEP_ATOL} (max|d|={err:.3g}); finite")
    check(tuple(padded.shape) == tuple(n + 2 * PAR_H for n in bg.shape)
          and bool(torch.isnan(padded[:PAR_H]).all()),
          f"the padded tile: {tuple(padded.shape)}, NaN halo strips")
    entries = [path_entry(stencil, "the distributed step's padded tile",
                          "K1", padded, PAR_H, mean, k1_launches)]
    print(f"  one rank peak device memory {peak:.3f} GB", flush=True)
    dist.destroy_process_group()
    analysis_a = out_a.cpu().numpy()
    del out_a, ref, flat, padded
    torch.cuda.empty_cache()

    # -- (b), (c): PAR_RANKS gloo ranks on this card --
    ranks, secs = timed(lambda: run_ranks(parallel_rank, PAR_RANKS,
                                          backend="gloo", timeout=600))
    r0 = ranks[0]
    print(f"  {PAR_RANKS} ranks: {secs:.3f} s in all (spawn, set-up, "
          f"steps); each on {r0['device']}, {r0['backend']}, strips "
          f"staged through host buffers: {r0['staged']}", flush=True)
    check(all(r["mesh"] == (2, 2) and r["staged"] for r in ranks),
          f"make_mesh({PAR_RANKS}): (2, 2), gloo through host buffers")
    for i, r in enumerate(ranks):
        report_step(f"rank {i} of {PAR_RANKS}", r["times"], r["parts"])
    peaks = ", ".join(f"{r['peak_gb']:.3f}" for r in ranks)
    print(f"  ranks' peak device memory {peaks} GB", flush=True)
    k1_ranks = [r["k1_step"] for r in ranks]
    check(k1_ranks == [PAR_REPS] * PAR_RANKS,
          f"K1 launched once a step on every rank ({k1_ranks})")
    got = torch.as_tensor(r0["analysis"], device=dev)
    ok, err = compare(got, torch.as_tensor(analysis_a, device=dev),
                      (STEP_RTOL, STEP_ATOL))
    check(ok, f"{PAR_RANKS} ranks: the gathered analysis == one rank's at "
              f"rtol {STEP_RTOL}, atol {STEP_ATOL} (max|d|={err:.3g})")
    sharded_launches = np.sum([r["sharded_launches"] for r in ranks], 0)
    check(list(sharded_launches) == [PAR_RANKS] * 3,
          f"sharded stencil: K1, K2 and K3 once on every rank "
          f"({list(sharded_launches)})")
    for stat, tol in ((mean, (K1_RTOL, K1_ATOL)), (mx, None),
                      (std, (K3_RTOL, K3_ATOL))):
        x = bg - 280.0 if stat == std else bg
        ok, err = compare(torch.as_tensor(r0["sharded"][stat], device=dev),
                          nops.neighbourhood(x, PAR_H, stat), tol)
        check(ok, f"sharded_neighbourhood {gt.Statistic(stat).name} h={PAR_H}"
                  f" on the (2, 2) mesh == the whole grid "
                  f"({'equal' if tol is None else tol}, max|d|={err:.3g})")
    # rank 0's padded tile: its neighbours' strips below and right, NaN
    # above and left
    ty, tx = (n // 2 + 2 * PAR_H for n in bg.shape)
    tile = F.pad(bg, (PAR_H,) * 4, value=float("nan"))[:ty, :tx]
    entries.append(path_entry(stencil, "the sharded stencil's tile", "K2",
                              tile.contiguous(), PAR_H, mx,
                              int(sharded_launches[1])))
    entries.append(path_entry(stencil, "the sharded stencil's tile", "K3",
                              (tile - 280.0).contiguous(), PAR_H, std,
                              int(sharded_launches[2])))
    return entries


def write_netcdf(path, lats, lons, elev, nt, field=None):
    """A NetCDF3 file (scipy) on a (Y, X) grid: time, latitude, longitude,
    altitude and, when given, air_temperature_2m (T, Y, X)."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w", mmap=False)
    nc.createDimension("time", nt)
    nc.createDimension("y", lats.shape[0])
    nc.createDimension("x", lats.shape[1])
    t = nc.createVariable("time", "d", ("time",))
    t[:] = 1.7e9 + 3600.0 * np.arange(nt)
    for name, data, kind in (("latitude", lats, "d"),
                             ("longitude", lons, "d"),
                             ("altitude", elev, "f")):
        v = nc.createVariable(name, kind, ("y", "x"))
        v[:] = data
    if field is not None:
        v = nc.createVariable("air_temperature_2m", "f", ("time", "y", "x"))
        v[:] = field
    nc.close()


def read_netcdf(path, names):
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    out = {n: np.array(nc.variables[n][:], dtype=np.float32) for n in names}
    nc.close()
    return out


def std64(x, h):
    """Windowed Std of the (T, Y, X) tensor x in float64 on its device,
    missing values skipped, windows clipped at the edges: the yardstick of
    Std on a 280 K field (ROADMAP F14)."""
    x = x.double()
    ok = torch.isfinite(x)
    xc = torch.where(ok, x - x[ok].mean(), 0.0)
    k = 2 * h + 1

    def box(v):
        return F.avg_pool2d(v[:, None], k, 1, h,
                            count_include_pad=True)[:, 0] * (k * k)

    n = box(ok.double())
    var = box(xc * xc) / n - (box(xc) / n) ** 2
    return torch.where(n > 0.5, var.clamp(min=0).sqrt(), torch.nan)


def cli_phase(gt, dev, lats, lons, plats, plons):
    """Phase 13: `python -m gridpp_tpu_torch` at MEPS size: 949 x 739 x 24
    leads bilinear to the 2000 x 2000 grid, then the neighbourhood
    calibrator (Mean, Max, Std h=7), on the card in a subprocess and in
    this process, against the same argv under host(); then -c oi on a 256^2
    cut. Returns the `kernels` line's entries."""
    import os
    import shutil
    import tempfile

    from gridpp_tpu_torch import client
    from gridpp_tpu_torch.api import _common
    from gridpp_tpu_torch.api.neighbourhood import _centred
    from gridpp_tpu_torch.ops import stencil

    root = os.path.dirname(os.path.abspath(__file__))
    wrappers = {"K1": stencil.neighbourhood_mean_cuda,
                "K2": stencil.neighbourhood_minmax_cuda,
                "K3": stencil.neighbourhood_var_cuda}
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        slats, slons = np.meshgrid(np.linspace(55, 62, MEPS_SHAPE[0]),
                                   np.linspace(5, 12, MEPS_SHAPE[1]),
                                   indexing="ij")
        selev, _ = terrain(slats, slons, fine=False)
        oelev, _ = terrain(lats, lons, fine=True)
        rng = np.random.default_rng(10)
        temp = (288 - 0.0065 * selev + rng.normal(
            0, 2, (N_LEAD,) + MEPS_SHAPE)).astype(np.float32)
        src = os.path.join(work, "in.nc")
        template = os.path.join(work, "template.nc")
        write_netcdf(src, slats, slons, selev, N_LEAD, temp)
        write_netcdf(template, lats, lons, oelev, N_LEAD)
        print(f"  files {time.perf_counter() - t0:.3f} s: in.nc "
              f"{os.path.getsize(src) / 1e6:.1f} MB ({MEPS_SHAPE} x "
              f"{N_LEAD} leads), template "
              f"{os.path.getsize(template) / 1e6:.1f} MB ({lats.shape})",
              flush=True)

        def argv(out):
            a = [src, out]
            for name, stat in CLI_VARS.items():
                a += ["-vi", "air_temperature_2m", "-v", name, "-d",
                      "bilinear"]
                if stat:
                    a += ["-c", "neighbourhood", f"radius={CLI_H}",
                          f"stat={stat}"]
            return a

        def run(route):
            out = os.path.join(work, f"out_{route}.nc")
            shutil.copy(template, out)
            t = time.perf_counter()
            if route == "subprocess":
                res = subprocess.run(
                    [sys.executable, "-m", "gridpp_tpu_torch"] + argv(out),
                    cwd=root, capture_output=True, text=True, timeout=900)
                check(res.returncode == 0,
                      f"python -m gridpp_tpu_torch on the card: exit "
                      f"{res.returncode} {res.stderr[-2000:]}")
                print(f"  its output: {res.stdout.strip()}", flush=True)
            elif route == "host":
                with _common.host():
                    check(client.main(argv(out)) == 0, "main under host()")
            else:
                check(client.main(argv(out)) == 0, "main on the card")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            res = read_netcdf(out, CLI_VARS)
            print(f"  {route}: {secs:.3f} s wall, output "
                  f"{os.path.getsize(out) / 1e6:.1f} MB", flush=True)
            os.remove(out)
            return res

        card = run("subprocess")
        host = run("host")
        for w in wrappers.values():
            w.launches = 0
        card2 = run("card")
        launches = {k: w.launches for k, w in wrappers.items()}
        check(launches == {"K1": N_LEAD, "K2": N_LEAD, "K3": N_LEAD},
              f"in-process card run: one K1, K2 and K3 launch a lead "
              f"({launches})")
        same = {n: bool(np.array_equal(card[n], card2[n], equal_nan=True))
                for n in CLI_VARS}
        print(f"  subprocess and in-process card outputs equal: {same}",
              flush=True)
        for name in CLI_VARS:
            check(card[name].shape == (N_LEAD,) + lats.shape
                  and bool(np.isfinite(card[name]).all()),
                  f"{name}: {card[name].shape}, finite")
        tens = {r: {n: torch.as_tensor(v[n], device=dev) for n in CLI_VARS}
                for r, v in (("card", card), ("host", host))}
        for name, tol in (("t_bilinear", DOWN_TOL),
                          ("t_mean", (K1_RTOL, K1_ATOL)), ("t_max", None)):
            ok, err = compare(tens["card"][name], tens["host"][name], tol)
            check(ok, f"{name}: card == host() "
                      f"({'equal' if tol is None else tol}, max|d|={err:.3g})")
        # Std of a 280 K field (F14): each route against float64 on its
        # own bilinear field
        errs = {}
        for r in ("card", "host"):
            want = std64(tens[r]["t_bilinear"], CLI_H)
            d = (tens[r]["t_std"].double() - want).abs()[
                torch.isfinite(want)]
            errs[r] = [float(torch.quantile(d[::7], q)) for q in
                       LR_F64_QUANTILES] + [float(d.max())]
        _, err = compare(tens["card"]["t_std"], tens["host"]["t_std"], None)
        check(all(c <= LR_F64_FACTOR * h for c, h in zip(errs["card"],
                                                          errs["host"])),
              f"t_std (F14) against float64, error quantiles "
              f"{LR_F64_QUANTILES} and max: card {errs['card']}, host "
              f"{errs['host']}: the card's at most {LR_F64_FACTOR}x the "
              f"host's (card vs host max|d|={err:.3g})")

        # the kernels at the CLI's shapes: lead 0 of the card's bilinear
        # field, as the calibrator uploads it
        x = tens["card"]["t_bilinear"][0].contiguous()
        k = 2 * CLI_H + 1
        entries = [
            path_entry(stencil, "the CLI's neighbourhood calibrator",
                       "K1", x, CLI_H, int(gt.Mean), launches["K1"],
                       library=lambda: F.avg_pool2d(
                           x[None, None], k, 1, CLI_H,
                           count_include_pad=False)[0, 0]),
            path_entry(stencil, "the CLI's neighbourhood calibrator",
                       "K2", x, CLI_H, int(gt.Max), launches["K2"],
                       library=lambda: F.max_pool2d(x[None, None], k, 1,
                                                    CLI_H)[0, 0]),
            path_entry(stencil, "the CLI's neighbourhood calibrator",
                       "K3", _centred(x), CLI_H, int(gt.Std),
                       launches["K3"])]
        del tens, card, card2, host

        # -- -c oi on a cut, Box-Cox: its back-transform smoothing is K1 --
        m, nt = CLI_OI_CUT, CLI_OI_LEADS
        src_oi = os.path.join(work, "in_oi.nc")
        write_netcdf(src_oi, slats, slons, selev, nt, temp[:nt])
        cut = os.path.join(work, "cut.nc")
        write_netcdf(cut, lats[:m, :m], lons[:m, :m], oelev[:m, :m], nt)
        inside = ((plats <= lats[m - 1, 0]) & (plons <= lons[0, m - 1]))
        idx = gt.Grid(lats[:m, :m], lons[:m, :m]).nearest_map(
            plats[inside], plons[inside])
        st_elev = oelev[:m, :m].reshape(-1)[idx]
        obs = 288 - 0.0065 * st_elev + rng.normal(0, 1, idx.size)
        par = os.path.join(work, "obs.txt")
        with open(par, "w") as fh:
            fh.write("lat lon elev t\n")
            for row in zip(plats[inside], plons[inside], st_elev, obs):
                fh.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        outs = {}
        for route in ("card", "host"):
            out = os.path.join(work, f"oi_{route}.nc")
            shutil.copy(cut, out)
            a = [src_oi, out, "-v", "air_temperature_2m", "-d",
                 "bilinear", "-c", "oi"] + CLI_OI_OPTS + ["-p", par]
            wrappers["K1"].launches = 0
            t0 = time.perf_counter()
            if route == "host":
                with _common.host():
                    check(client.main(a) == 0, "-c oi under host()")
            else:
                check(client.main(a) == 0, "-c oi on the card")
            secs = time.perf_counter() - t0
            outs[route] = read_netcdf(out, ["air_temperature_2m"])[
                "air_temperature_2m"]
            print(f"  -c oi {' '.join(CLI_OI_OPTS)}, {m}x{m} x {nt} "
                  f"leads, {idx.size} stations, {route}: {secs:.3f} s, K1 "
                  f"launches {wrappers['K1'].launches}", flush=True)
            if route == "card":
                k1_oi = wrappers["K1"].launches
        d = float(np.nanmax(np.abs(outs["card"] - outs["host"])))
        check(bool(np.isfinite(outs["card"]).all()) and d <= CARD_CPU_TOL
              and k1_oi == 4 * nt,
              f"-c oi: card vs host() max|d|={d:.3g} (<= {CARD_CPU_TOL}), "
              f"finite, K1 launched {k1_oi} times (radii 25, 5, 3, 3 a "
              "lead)")
        return entries
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 14: the port's tools on the card -----------------------------------
SWEEP_SEEDS = range(10)          # the reference's round-5 sweep
TABLE_S, TABLE_N = 1.0, 3        # the table's -s and -n
# the scaling harness at its defaults (512^2, 2000 obs) on 2 ranks, timed
# over its first step: a step takes ~50 s on one CPU core
SCALE_HOSTS = 2


def qf_entry(stencil, nops, label, x, q, h, thr, launches):
    """The `kernels` line's entry of K4 on a path's (Y, X) field x: held
    against its plain version bit for bit, timed beside it, with its
    bound (phase 4's work)."""
    def card():
        return stencil.neighbourhood_quantile_fast_cuda(x, q, h, h, thr)

    def plain():
        return nops._quantile_fast_xla(x, q, h, thr)

    ok, err = compare(card(), plain(), None)
    check(ok, f"K4 on {label} {tuple(x.shape)} h={h} vs plain: bit for bit "
              f"(max|d|={err:.3g})")
    entry = {"name": f"neighbourhood_quantile_fast_cuda ({label})",
             "route": "cuda",
             "source": "gridpp_tpu_torch/csrc/neighbourhood_wide.cu",
             "replaces": f"{PALLAS}:465", "launches": launches,
             "max_abs_err": err, "ms": event_ms(card),
             "cold_ms": cold_ms(lambda a, th: stencil
                                .neighbourhood_quantile_fast_cuda(
                                    a, q, h, h, th), x, thr)}
    entry.update(device_ms=device_ms(card, at_least=0.5 * entry["ms"]),
                 plain_ms=event_ms(plain, reps=5), library_ms=None)
    entry["bound_ms"], entry["bound_by"] = bound_ms("K4", x.shape, h,
                                                    thr.numel())
    dev_ms = entry["device_ms"]
    print(f"  K4 on {label} {tuple(x.shape)}, h={h}: kernel "
          f"{entry['ms']:.4f} ms, cold {entry['cold_ms']:.4f} ms (device only "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), "
          f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} "
          f"ms ({entry['bound_by']})", flush=True)
    return entry


def tools_phase(gt, dev):
    """Phase 14: gridpp_tpu_torch.tools on the card, in order: the all-API
    smoke (both routes), the parity sweep over SWEEP_SEEDS, the
    per-operator table on both routes (K1 at 10000^2, K2 and K4 at 2000^2
    its `kernels` entries, with the table's launches) and the scaling
    harness on CPU ranks. Returns the `kernels` line's entries."""
    from gridpp_tpu_torch.ops import neighbourhood as nops
    from gridpp_tpu_torch.ops import stencil
    from gridpp_tpu_torch.tools import (benchmark_ops, scaling, smoke,
                                        sweep_parity)

    wrappers = {"K1": stencil.neighbourhood_mean_cuda,
                "K2": stencil.neighbourhood_minmax_cuda,
                "K3": stencil.neighbourhood_var_cuda,
                "K4": stencil.neighbourhood_quantile_fast_cuda,
                "K5": stencil.neighbourhood_members_cuda}

    def indent(line="", **_):
        print(f"  {line}", flush=True)

    # -- the smoke: (a) the top level, (b) the device routes, entry points
    t0 = time.perf_counter()
    res = smoke.run(dev)
    passed = smoke.report(res, log=indent)
    c = res["counts"]
    check(passed and not res["uncovered"],
          f"SMOKE PASS in {time.perf_counter() - t0:.3f} s: {res['calls']} "
          f"calls; {c['host']} top-level calls left the card untouched, "
          f"{c['device']} device-route calls of "
          f"{len(res['device_routes'])} functions each allocated on it; "
          f"the entry points launched {res['launches']}")

    # -- the parity sweep: every pipeline against its API, on the card
    t0 = time.perf_counter()
    worst = sweep_parity.worst(sweep_parity.sweep(SWEEP_SEEDS, dev,
                                                  log=indent))
    check(worst < sweep_parity.TOL,
          f"parity sweep, seeds {SWEEP_SEEDS[0]}-{SWEEP_SEEDS[-1]} x "
          f"{len(sweep_parity.PIPELINES)} pipelines x 2 routes: worst "
          f"{worst:.3g} < {sweep_parity.TOL} "
          f"({time.perf_counter() - t0:.3f} s)")

    # -- the per-operator table, counts from 0
    torch.cuda.empty_cache()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rows = benchmark_ops.run(TABLE_S, TABLE_N, device=str(dev), log=indent)
    launches = {k: w.launches for k, w in wrappers.items()}
    card_rows = [r for r in rows if r["card_s"] is not None]
    check(all(r["within_bar"] for r in card_rows),
          f"the table: {len(rows)} rows on the host route, {len(card_rows)} "
          f"on the card route, each within its bar of the host "
          f"({time.perf_counter() - t0:.3f} s; launches {launches})")
    for k in ("K1", "K2", "K4"):
        check(launches[k] >= 1, f"{k} launched on the table's card route "
                                f"({launches[k]} launches)")
    s = int(10000 * TABLE_S)
    zeros = torch.zeros((s, s), device=dev)
    mean, mx = int(gt.Mean), int(gt.Max)
    # the row's field is zeros; K1 held at that shape on a 280 K field too
    x = torch.as_tensor(field(np.random.default_rng(14), (s, s), 0.1, 280.0,
                              5.0), device=dev)
    ok, err = compare(stencil.neighbourhood_mean_cuda(x, 7, 7, mean),
                      stencil.neighbourhood_mean_plain(x, 7, 7, mean),
                      (K1_RTOL, K1_ATOL))
    check(ok, f"K1 at {s}x{s} h=7 on normal(280, 5) with 10% NaN vs plain: "
              f"max|d|={err:.3g}")
    del x
    entries = [path_entry(
        stencil, "the table's neighbourhood 10000² mean", "K1", zeros, 7,
        mean, launches["K1"], library=lambda: F.avg_pool2d(
            zeros[None, None], 15, 1, 7, count_include_pad=False)[0, 0])]
    del zeros
    uni = torch.as_tensor(np.random.default_rng(2).random(
        (2000, 2000)).astype(np.float32), device=dev)
    entries.append(path_entry(
        stencil, "the table's neighbourhood 2000² max", "K2", uni, 7, mx,
        launches["K2"],
        library=lambda: F.max_pool2d(uni[None, None], 15, 1, 7)[0, 0]))
    entries.append(qf_entry(stencil, nops,
                            "the table's neighbourhood_quantile_fast 2000²",
                            uni, 0.5, 7, torch.linspace(0, 1, 11, device=dev),
                            launches["K4"]))

    # -- the scaling harness: CPU ranks, no card
    report = scaling.measure(SCALE_HOSTS, iters=1, warm=False, log=indent)
    check(report["bit_parity"],
          f"scaling, {report['hosts']} gloo CPU ranks on cores "
          f"{report['cores']} of {report['ncpu']}, {report['grid']}, "
          f"{report['obs']} obs: the gathered analysis == one rank's bit "
          f"for bit; efficiency {report['efficiency']:.3f} "
          f"({report['wall_s']:.3f} s)")
    return entries


# -- phase 15: the roofline ---------------------------------------------------
ROOFLINE_SCALE = 1.0
# a share of a peak past this is a count below the work done
MAX_SHARE = 105.0


def roofline_phase(dev):
    """Phase 15: gridpp_tpu_torch.tools.roofline at scale ROOFLINE_SCALE on
    the card, as `python -m gridpp_tpu_torch.tools.roofline` runs it: its
    rows (each held to its plain version first), their table, and checks
    that every row has its warm, cold and bound times, that its kernel
    launched, that no share passes MAX_SHARE, that the library call was
    timed where one exists, and that the rows launched every kernel of
    ops.stencil.KERNELS."""
    from gridpp_tpu_torch.ops import stencil
    from gridpp_tpu_torch.tools import roofline

    def indent(line="", **_):
        print(f"  {line}", flush=True)

    t0 = time.perf_counter()
    rows = roofline.run(ROOFLINE_SCALE, dev, log=indent)
    roofline.table(rows, log=indent)
    want = [r.label for r in roofline.rows(ROOFLINE_SCALE)]
    check([r["kernel"] for r in rows] == want,
          f"the roofline's {len(want)} rows, in order "
          f"({time.perf_counter() - t0:.3f} s)")
    fmt = roofline._fmt
    for r in rows:
        numbers = [r[k] for k in ("warm_ms", "cold_ms", "bound_ms",
                                  "pct_peak", "pct_measured_bw")]
        check(all(isinstance(v, float) and v > 0 for v in numbers)
              and max(numbers[3:]) <= MAX_SHARE,
              f"{r['kernel']}: warm {fmt(r['warm_ms'])} ms, cold "
              f"{fmt(r['cold_ms'])} ms, bound {fmt(r['bound_ms'])} ms "
              f"({r['bound_by']}), {fmt(r['pct_peak'], '.1f')}% of it, "
              f"{fmt(r['pct_measured_bw'], '.1f')}% of the measured "
              "bandwidth")
        if r["kind"] in ("K1", "K2", "K5") and r["sources"]:
            check(isinstance(r["library_ms"], float),
                  f"{r['kernel']}: library call {fmt(r['library_ms'])} ms")
    covered = set().union(*(set(r["sources"]) for r in rows))
    check(covered == set(stencil.KERNELS),
          f"the rows launched every kernel source: {sorted(covered)}")
    return rows


# -- phase 16: the benchmark tool ---------------------------------------------
SCRIPT_LIMIT_S = 1200.0
BENCH_REPEATS = 3
BENCH_LIMIT_S = 300.0      # the tool's full-size run on the card
# phase 16 at --repeats 3 (the tool, the link rates, the traced Pipeline's
# set-up and cycles, K1's entry); past what is left, --repeats 1
BENCH_PHASE_S = 240.0
TRACE_CYCLES = 4


def link_rates(dev, reps=5):
    """Best-of-reps ms of moving bench.py's 16 MB field and 160 MB
    ensemble between host and card, pageable (torch.as_tensor, .cpu())
    and pinned (non_blocking copies), and of the host work a serving
    cycle adds: the finiteness check, the copy into a pinned buffer and
    the copy out of it (numpy's, and torch's on its intra-op threads, as
    serve_stream makes them, the check on the pinned copy); printed with
    GB/s."""
    rng = np.random.default_rng(16)
    out = {}
    for label, shape in (("16 MB", (2000, 2000)),
                         ("160 MB", (2000, 2000, 10))):
        host = rng.normal(280, 5, shape).astype(np.float32)
        pin = torch.empty(shape, pin_memory=True)
        card = torch.as_tensor(host, device=dev)
        pin_np = pin.numpy()

        def best(fn):
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
            return min(ts) * 1e3

        row = {
            "h2d pageable": best(lambda: torch.as_tensor(host, device=dev)),
            "h2d pinned": best(lambda: pin.to(dev, non_blocking=True)),
            "d2h pageable": best(lambda: card.cpu().numpy()),
            "d2h pinned": best(lambda: pin.copy_(card, non_blocking=True)),
            "host isfinite": best(lambda: bool(np.isfinite(host).all())),
            "host isfinite of the pinned copy, torch threads": best(
                lambda: bool(torch.isfinite(pin).all())),
            "host copy into pinned": best(lambda: np.copyto(pin_np, host)),
            "host copy out of pinned": best(lambda: pin_np.copy()),
            "host copy into pinned, torch threads": best(
                lambda: pin.copy_(torch.from_numpy(host))),
            "host copy out of pinned, torch threads": best(
                lambda: torch.empty(shape).copy_(pin).numpy())}
        out[label] = row
        print(f"  {label}: " + ", ".join(
            f"{k} {ms:.3f} ms ({host.nbytes / ms / 1e6:.2f} GB/s)"
            for k, ms in row.items()), flush=True)
        del pin, card
    return out


def device_overlaps(prof):
    """(device-to-host copies, [(copy, kernel, overlap us)]) of a
    torch.profiler run: each copy with every kernel that ran while it
    did."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    d2h = [e for e in events if "DtoH" in e.name]
    kernels = [e for e in events if not e.name.startswith(("Memcpy",
                                                           "Memset"))]
    pairs = []
    for m in d2h:
        for k in kernels:
            lo = max(m.time_range.start, k.time_range.start)
            hi = min(m.time_range.end, k.time_range.end)
            if hi > lo:
                pairs.append((m, k, hi - lo))
    return d2h, pairs


def bench_tool(repeats):
    """`python -m gridpp_tpu_torch.tools.bench --repeats repeats` at full
    size in a subprocess: its exit code, time, key set, numbers, backend
    and checks; prints its progress and, on a line of its own, its JSON
    line. Returns the K1 launches the tool counted."""
    from gridpp_tpu_torch.tools import bench
    cmd = [sys.executable, "-m", "gridpp_tpu_torch.tools.bench",
           "--repeats", str(repeats)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True,
                         timeout=BENCH_LIMIT_S + 120)
    secs = time.perf_counter() - t0
    for line in res.stderr.splitlines():
        print(f"  | {line}", flush=True)
    check(res.returncode == 0, f"{' '.join(cmd[1:])}: exit "
                               f"{res.returncode} in {secs:.3f} s")
    check(secs <= BENCH_LIMIT_S,
          f"the tool's full-size run within {BENCH_LIMIT_S:.0f} s "
          f"({secs:.3f} s)")
    line = res.stdout.strip().splitlines()[-1]
    print(f"  bench line: {line}", flush=True)
    out = json.loads(line)
    check(list(out) == bench.output_keys(),
          f"the line's {len(out)} keys: bench.py's and the four additions")
    numbers = {k: v for k, v in out.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    check(all(np.isfinite(v) and v > 0 for v in numbers.values())
          and set(out) - set(numbers) == {"metric", "unit", "headline_note",
                                           "backend", "device_name"},
          f"all {len(numbers)} numbers finite and positive")
    check(out["backend"] == "cuda" and out["device_name"]
          == torch.cuda.get_device_name(), f"backend {out['backend']}, "
          f"{out['device_name']}, {out['device_power_limit_w']} W")
    for what in ["ok: general == general_resolve bit for bit",
                 "ok: fast serving: K1 launched"] + [
            f"ok: {key}: serve_stream's {c} analyses equal the serial loop's"
            for key, c in bench.STREAMED.items()]:
        check(what in res.stderr, f"the tool's check: {what}")
    tool_k1 = int(res.stderr.split("K1 launches in all: ")[1].split()[0])
    want = (len(bench.DETERMINISTIC) * (1 + repeats * bench.CYCLES) + 1
            + 2 * bench.STREAMED["fast"])
    check(tool_k1 == want,
          f"the tool: one K1 launch a cycle of fast, general, "
          f"general_resolve and the fast serving loops ({tool_k1})")
    for key in bench.PATHS:
        print(f"  {key}: compute {out[f'{key}_compute_pts_per_s']:.1f} "
              f"gridpoints/s (spread {out[f'{key}_compute_spread']:.4f}), "
              f"d2h {out[f'{key}_d2h_s']:.6f} s, serving "
              f"{out[f'{key}_serving_pts_per_s']:.1f}", flush=True)
    for key in bench.STREAMED:
        s, o = (out[f"{key}_serving_{m}_pts_per_s"]
                for m in ("serial", "overlapped"))
        print(f"  {key} serving: serial {s:.1f}, serve_stream {o:.1f} "
              f"gridpoints/s ({o / s:.4f}x)", flush=True)
    return tool_k1


def stream_trace(gt, dev):
    """Pipeline.serve_stream at bench.py's configuration over TRACE_CYCLES
    cycles under torch.profiler, after a warm cycle: equal to a loop of
    __call__ bit for bit, and a device-to-host copy overlapping a kernel.
    Then, warm, the tool's serial loop and serve_stream on those cycles in
    turn, three times each, and the host's finiteness check of a cycle.
    Returns (the K1 launches it counted, the background on the card)."""
    from gridpp_tpu_torch.ops import stencil
    k1 = stencil.neighbourhood_mean_cuda
    before = k1.launches
    lats, lons, plats, plons, background, noise = bench_problem()
    p = plats.size
    grid = gt.Grid(lats, lons)
    points = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    pobs = background.reshape(-1)[grid.nearest_map(plats, plons)] + noise
    t0 = time.perf_counter()
    pipe = gt.Pipeline(grid, points, gt.BarnesStructure(10000.0),
                       halfwidth=7, statistic=gt.Mean, max_points=10,
                       ratios=np.full(p, 0.1, np.float32), device=dev)
    print(f"  Pipeline set-up {time.perf_counter() - t0:.3f} s", flush=True)
    cycles = [(background + np.float32(i), pobs)
              for i in range(TRACE_CYCLES)]
    list(pipe.serve_stream(cycles[:1]))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        streamed = list(pipe.serve_stream(cycles))
        traced = time.perf_counter() - t0
    looped = [pipe(*c) for c in cycles]
    check(len(streamed) == TRACE_CYCLES
          and all(np.array_equal(a, b) for a, b in zip(streamed, looped)),
          f"serve_stream's {TRACE_CYCLES} analyses == a loop of __call__ "
          f"bit for bit ({traced * 1e3:.3f} ms under the profiler)")
    # warm: the tool's loops back to back, three times, and the host's
    # finiteness check of each cycle's field
    def serial():
        return [pipe.run_device(*(torch.as_tensor(a, device=dev) for a in c),
                                assume_valid=True).cpu().numpy()
                for c in cycles]

    for k in range(3):
        (_, t_serial), (_, t_stream) = (
            timed(serial), timed(lambda: list(pipe.serve_stream(cycles))))
        print(f"  warm, try {k}: serial {t_serial / TRACE_CYCLES * 1e3:.3f}"
              f", serve_stream {t_stream / TRACE_CYCLES * 1e3:.3f} ms a "
              "cycle", flush=True)
    t0 = time.perf_counter()
    for c in cycles:
        bool(np.isfinite(c[0]).all() and np.isfinite(c[1]).all())
    print(f"  the host's finiteness check of a cycle's field: "
          f"{(time.perf_counter() - t0) / TRACE_CYCLES * 1e3:.3f} ms",
          flush=True)
    d2h, pairs = device_overlaps(prof)
    longest = max(pairs, key=lambda x: x[2], default=None)
    check(bool(pairs),
          f"{len(d2h)} device-to-host copies in the trace, "
          f"{len({id(m) for m, _, _ in pairs})} overlapping a kernel"
          + ("" if longest is None else
             f"; the longest overlap {longest[2]:.1f} us, {longest[0].name}"
             f" beside {longest[1].name[:60]}"))
    return k1.launches - before, torch.as_tensor(background, device=dev)


def bench_phase(gt, dev, t_start):
    """Phase 16: the link rates, `python -m gridpp_tpu_torch.tools.bench`
    at full size (bench_tool; --repeats BENCH_REPEATS, or 1 when less than
    BENCH_PHASE_S of the script's SCRIPT_LIMIT_S is left), then
    stream_trace in process. Launch counts set to 0 before the tool and
    read after the trace; returns K1's `kernels` entry."""
    from gridpp_tpu_torch.ops import stencil

    left = SCRIPT_LIMIT_S - (time.perf_counter() - t_start)
    repeats = BENCH_REPEATS if left > BENCH_PHASE_S else 1
    print(f"  {left:.1f} s of the script's {SCRIPT_LIMIT_S:.0f} left: "
          f"--repeats {repeats}", flush=True)
    link_rates(dev)
    stencil.neighbourhood_mean_cuda.launches = 0
    tool_k1 = bench_tool(repeats)
    launches, x = stream_trace(gt, dev)
    check(launches == 1 + 8 * TRACE_CYCLES,
          f"K1 once a cycle in process ({launches} launches)")
    entry = path_entry(
        stencil, "the bench tool's Pipeline cycles", "K1", x, 7,
        int(gt.Mean), tool_k1 + launches,
        library=lambda: F.avg_pool2d(x[None, None], 15, 1, 7,
                                     count_include_pad=False)[0, 0])
    return entry


def main():
    t_start = time.perf_counter()
    laps = [t_start]
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
    from gridpp_tpu_torch.ops import graph
    from gridpp_tpu_torch.ops import neighbourhood as nops
    from gridpp_tpu_torch.ops import stencil

    dev = torch.device("cuda", torch.cuda.current_device())
    mean, mx, std = int(gt.Mean), int(gt.Max), int(gt.Std)
    wrappers = {"K1": stencil.neighbourhood_mean_cuda,
                "K2": stencil.neighbourhood_minmax_cuda,
                "K3": stencil.neighbourhood_var_cuda,
                "K4": stencil.neighbourhood_quantile_fast_cuda,
                "K5": stencil.neighbourhood_members_cuda}

    # -- 2. build --
    lap(laps)
    print("[build]", flush=True)

    def timed_build(name):
        t = time.perf_counter()
        lib = (graph.build_conditional() if name == "graph_cond"
               else stencil.build_kernel(name))
        return lib, time.perf_counter() - t

    t0 = time.perf_counter()
    sources = list(stencil.KERNELS) + ["graph_cond"]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(timed_build, sources)))
    print(f"  K1-K5, the wide route, the EnSI transform and the graph "
          "conditional: "
          f"{len(builds)} nvcc in parallel, "
          f"{time.perf_counter() - t0:.3f} s in all", flush=True)
    for name, (lib, secs) in builds.items():
        print(f"  -- {name}: {secs:.3f} s\n{build_log(lib)}", flush=True)
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "native host library built")
    print(f"  native build {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 3. each kernel against its plain version --
    rng = np.random.default_rng(1)
    cases = [((2000, 2000), 7, 0.0), ((2000, 2000), 7, 0.1),
             ((40, 60), 3, 0.1), ((17, 250), 7, 0.1), ((300, 129), 1, 0.1),
             ((31, 31), 0, 0.1), ((256, 129), 7, 0.1), ((160, 128), 3, 0.1),
             ((256, 300), 7, 0.1), ((3, 256, 300), 7, 0.1),
             ((1, 500), 3, 0.1), ((500, 1), 3, 0.1), ((97, 301), 7, 0.1),
             ((33, 129), 9, 0.1), ((200, 130), 32, 0.1),
             ((200, 130), 60, 0.1), ((300, 400), 7, 1e-5),
             ((N_ENS, 2000, 2000), 7, 0.1), ((N_ENS, 2000, 2000), 7, 0.0)]
    # statistic -> (kernel, its wrapper, its plain version, bar)
    plane_kernels = [
        (stat, "K1", stencil.neighbourhood_mean_cuda,
         stencil.neighbourhood_mean_plain, (K1_RTOL, K1_ATOL))
        for stat in stencil.MEAN_STATS] + [
        (stat, "K2", stencil.neighbourhood_minmax_cuda,
         stencil.neighbourhood_minmax_plain, None)
        for stat in stencil.MINMAX_STATS] + [
        (stat, "K3", stencil.neighbourhood_var_cuda,
         stencil.neighbourhood_var_plain, (K3_RTOL, K3_ATOL))
        for stat in stencil.VAR_STATS]
    err = dict.fromkeys(wrappers, 0.0)
    lap(laps)
    print("[K1, K2, K3 vs plain versions]", flush=True)
    for shape, h, nan_frac in cases:
        # the h >= 32 and the sparse-NaN cases on a 280 K field: wide
        # windows of a zero-mean field cancel below f32's rounding of the
        # partial sums
        mu = 280.0 if h >= 32 or nan_frac < 0.01 else 0.0
        x = torch.as_tensor(field(rng, shape, nan_frac, mu, 5.0 if mu
                                  else 10.0), device=dev)
        hy = min(h, shape[-2] - 1)
        hx = min(h, shape[-1] - 1)
        for stat, k, kernel, plain, tol in plane_kernels:
            xs = x - 280.0 if mu and stat in stencil.VAR_STATS else x
            if h == 0:
                # h = 0 never launches a kernel (the ops' pass-through)
                got = nops.neighbourhood(xs, 0, stat)
                want = nops.neighbourhood(xs.cpu(), 0, stat).to(dev)
            else:
                got = kernel(xs, hy, hx, stat)
                want = plain(xs, hy, hx, stat)
            ok, e = compare(got, want, tol)
            check(ok, f"{k} {shape} h={h} nan={nan_frac} stat={stat} "
                      f"max|d|={e:.3g}")
            err[k] = max(err[k], e)

    lap(laps)
    print("[K4 vs plain version]", flush=True)
    for shape, h, nan_frac in cases:
        if len(shape) != 2 or min(shape) == 1 or nan_frac < 0.01:
            continue
        xn = field(rng, shape, nan_frac)
        thr = np.quantile(xn[np.isfinite(xn)],
                          np.linspace(0, 1, 11)).astype(np.float32)
        x = torch.as_tensor(xn, device=dev)
        thr = torch.as_tensor(thr, device=dev)
        hy = min(h, shape[-2] - 1)
        hx = min(h, shape[-1] - 1)
        for q in (0.0, 0.25, 0.5, 0.9, 1.0):
            got = stencil.neighbourhood_quantile_fast_cuda(x, q, hy, hx, thr)
            ok, e = compare(got, nops._quantile_fast_xla(x, q, h, thr), None)
            check(ok, f"K4 {shape} h={h} nan={nan_frac} q={q} equal, "
                      f"max|d|={e:.3g}")
            err["K4"] = max(err["K4"], e)
    # either side of the 8/16-bit lane boundary of the window counts (h=7:
    # 225 cells, h=8: 289), thresholds that fill, straddle and overflow the
    # packed words, and h=88 (the plain version calls K1 on the card, which
    # takes h=88 by the wide route); thresholds unsorted in one case
    for shape, h, qs in (((256, 300), 7, (0.1, 0.5, 1.0)),
                         ((256, 300), 8, (0.1, 0.5, 1.0)),
                         ((180, 200), 88, (0.5,))):
        xn = field(rng, shape, 0.1)
        x = torch.as_tensor(xn, device=dev)
        for t in (1, 4, 5, 11, 12, 33):
            thr = np.quantile(xn[np.isfinite(xn)],
                              np.linspace(0, 1, t)).astype(np.float32)
            if t == 12:
                thr = rng.permutation(thr)
            thr = torch.as_tensor(thr, device=dev)
            for q in qs:
                got = stencil.neighbourhood_quantile_fast_cuda(x, q, h, h,
                                                               thr)
                want = nops._quantile_fast_xla(x, q, h, thr)
                ok, e = compare(got, want, None)
                check(ok, f"K4 {shape} h={h} T={t} q={q} equal")
    ties = torch.as_tensor(
        np.random.default_rng(11).integers(0, 5, (30, 40)), device=dev,
        dtype=torch.float32)
    ties[4, 7] = torch.nan
    tthr = torch.arange(5, dtype=torch.float32, device=dev)
    for h in (1, 7, 8):
        for q in (float(np.float32(1 / 3)), 0.5, 0.25,
                  float(np.float32(2 / 9))):
            got = stencil.neighbourhood_quantile_fast_cuda(ties, q, h, h,
                                                           tthr)
            ok, e = compare(got, nops._quantile_fast_xla(ties, q, h, tthr),
                            None)
            check(ok, f"K4 exact cdf ties h={h} q={q}: equal")
    got = stencil.neighbourhood_quantile_fast_cuda(x, float("nan"), hy, hx,
                                                   thr)
    check(bool(torch.isnan(got).all()), "K4 NaN quantile: all NaN")

    lap(laps)
    print("[K5 vs plain version and K1/K2 per member]", flush=True)
    xm = torch.as_tensor(field(rng, (2000, 2000, 10), 0.1), device=dev)
    # EnSI's input: a NaN-free normal(280, 5) ensemble
    ens = torch.as_tensor(np.random.default_rng(5).normal(
        280, 5, (2000, 2000, N_ENS)).astype(np.float32), device=dev)
    # X * E not a multiple of 4 (unaligned rows) for every E but 10 at 2000
    k5_cases = [(torch.as_tensor(field(rng, (130, 257, e), 0.1), device=dev),
                 h, f"(130, 257, {e}) h={h} nan=0.1")
                for e in (1, 3, 10, 25) for h in (2, 7)]
    k5_cases += [(xm, 7, "(2000, 2000, 10) h=7 nan=0.1"),
                 (ens, 7, "(2000, 2000, 10) h=7 normal(280, 5)")]
    for xk, h, label in k5_cases:
        for stat in stencil.MEMBER_STATS:
            tol = None if stat in stencil.MINMAX_STATS else (K1_RTOL,
                                                             K1_ATOL)
            got = stencil.neighbourhood_members_cuda(xk, h, h, stat)
            ok, e = compare(got, stencil.neighbourhood_members_plain(
                xk, h, h, stat), tol)
            check(ok, f"K5 {label} stat={stat} vs plain max|d|={e:.3g}")
            err["K5"] = max(err["K5"], e)
            per = (stencil.neighbourhood_minmax_cuda
                   if stat in stencil.MINMAX_STATS
                   else stencil.neighbourhood_mean_cuda)
            for k in sorted({0, xk.shape[2] - 1}):
                ok, e = compare(got[:, :, k], per(
                    xk[:, :, k].contiguous(), h, h, stat), tol)
                check(ok, f"K5 {label} stat={stat} member {k} vs K1/K2 "
                          f"max|d|={e:.3g}")
    del k5_cases

    lap(laps)
    print("[wide route vs plain versions]", flush=True)
    wide_err = 0.0
    for w in wrappers.values():
        w.wide = 0
    x280 = torch.as_tensor(field(rng, (2000, 2000), 0.1, 280.0, 5.0),
                           device=dev)
    for h in (81, 100, 300):
        for stat, k, kernel, plain, tol in plane_kernels:
            xs = x280 - 280.0 if stat in stencil.VAR_STATS else x280
            ok, e = compare(kernel(xs, h, h, stat), plain(xs, h, h, stat),
                            tol)
            check(ok, f"{k} wide 2000x2000 h={h} stat={stat} max|d|={e:.3g}")
            wide_err = max(wide_err, e)
    # K4 at h=8, h=120 and h=300 (361,201 cells a window), with 10% NaN and
    # an all-NaN region, and on exact cdf ties, bit for bit
    xn = field(rng, (2000, 2000), 0.1)
    xn[300:700, 500:1100] = np.nan
    xq = torch.as_tensor(xn, device=dev)
    xt = torch.as_tensor(rng.integers(0, 5, (2000, 2000)), device=dev,
                         dtype=torch.float32)
    xt[4, 7] = torch.nan
    # the plain K4 smooths its (T, Y, X) indicator planes with K1, by the
    # route K1's plan picks
    k4_wide_cases, k1_wide_plain = 0, 0
    for h in (8, 120, 300):
        for t_ in (1, 11, 33):
            thrq = torch.as_tensor(np.quantile(
                xn[np.isfinite(xn)], np.linspace(0, 1, t_)).astype(
                np.float32), device=dev)
            for q in (0.1, 0.5, 0.9):
                ok, e = compare(
                    stencil.neighbourhood_quantile_fast_cuda(xq, q, h, h,
                                                             thrq),
                    nops._quantile_fast_xla(xq, q, h, thrq), None)
                check(ok, f"K4 wide 2000x2000 h={h} T={t_} q={q} (10% NaN, "
                          "an all-NaN region) equal")
                err["K4"] = max(err["K4"], e)
                k4_wide_cases += 1
                k1_wide_plain += stencil.stencil_plan(
                    "K1", (t_, 2000, 2000), h, h, mean).route == "wide"
        for q in (float(np.float32(1 / 3)), float(np.float32(2 / 9))):
            ok, e = compare(stencil.neighbourhood_quantile_fast_cuda(
                xt, q, h, h, tthr), nops._quantile_fast_xla(xt, q, h, tthr),
                None)
            check(ok, f"K4 wide exact cdf ties 2000x2000 h={h} q={q} equal")
            err["K4"] = max(err["K4"], e)
            k4_wide_cases += 1
            k1_wide_plain += stencil.stencil_plan(
                "K1", (tthr.numel(), 2000, 2000), h, h, mean).route == "wide"
    del xq, xt
    xw = torch.as_tensor(field(rng, (2000, 2000, N_ENS), 0.1, 280.0, 5.0),
                         device=dev)
    for stat in stencil.MEMBER_STATS:
        tol = None if stat in stencil.MINMAX_STATS else (K1_RTOL, K1_ATOL)
        ok, e = compare(stencil.neighbourhood_members_cuda(xw, 150, 150, stat),
                        stencil.neighbourhood_members_plain(xw, 150, 150,
                                                            stat), tol)
        check(ok, f"K5 wide 2000x2000x10 h=150 stat={stat} max|d|={e:.3g}")
        wide_err = max(wide_err, e)
    del xw
    wide_calls = {k: w.wide for k, w in wrappers.items()}
    # the plan's routes, and the plain K4's smoothing of its (11, Y, X)
    # stack at h=120 through K1
    want_calls = {k: sum(stencil.stencil_plan(k, (2000, 2000), h, h, st)
                         .route == "wide" for h in (81, 100, 300)
                         for st in stats)
                  for k, stats in (("K1", stencil.MEAN_STATS),
                                   ("K2", stencil.MINMAX_STATS),
                                   ("K3", stencil.VAR_STATS))}
    want_calls["K1"] += k1_wide_plain
    want_calls.update(K4=k4_wide_cases, K5=len(stencil.MEMBER_STATS))
    check(wide_calls == want_calls,
          f"the wide cases took the plan's routes: {wide_calls}")

    # -- 4. timings --
    lap(laps)
    print("[timings, CUDA events]", flush=True)
    lats, lons, plats, plons, background, noise = bench_problem()
    bg0 = torch.as_tensor(background, device=dev)
    anom = bg0 - 280.0
    uni = torch.as_tensor(np.random.default_rng(2).random(
        (2000, 2000)).astype(np.float32), device=dev)
    thr11 = torch.linspace(0, 1, 11, device=dev)
    ms = {
        "K1": (lambda: stencil.neighbourhood_mean_cuda(bg0, 7, 7, mean),
               lambda: stencil.neighbourhood_mean_plain(bg0, 7, 7, mean)),
        "K2": (lambda: stencil.neighbourhood_minmax_cuda(bg0, 7, 7, mx),
               lambda: stencil.neighbourhood_minmax_plain(bg0, 7, 7, mx)),
        "K3": (lambda: stencil.neighbourhood_var_cuda(anom, 7, 7, std),
               lambda: stencil.neighbourhood_var_plain(anom, 7, 7, std)),
        "K4": (lambda: stencil.neighbourhood_quantile_fast_cuda(
                   uni, 0.5, 7, 7, thr11),
               lambda: nops._quantile_fast_xla(uni, 0.5, 7, thr11)),
        "K5": (lambda: stencil.neighbourhood_members_cuda(ens, 7, 7, mean),
               lambda: stencil.neighbourhood_members_plain(ens, 7, 7, mean)),
    }
    # one PyTorch call computing the same function on NaN-free input, where
    # there is one (timed here only; the port never calls it). ens's
    # (1, E, Y, X) view is channels-last memory, as (Y, X, E) is.
    library = {
        "K1": lambda: F.avg_pool2d(bg0[None, None], 15, 1, 7,
                                   count_include_pad=False),
        "K2": lambda: F.max_pool2d(bg0[None, None], 15, 1, 7),
        "K5": lambda: F.avg_pool2d(ens.permute(2, 0, 1)[None], 15, 1, 7,
                                   count_include_pad=False),
    }
    lib_out = {"K1": library["K1"]()[0, 0], "K2": library["K2"]()[0, 0],
               "K5": library["K5"]()[0].permute(1, 2, 0)}
    for k, want in lib_out.items():
        ok, e = compare(ms[k][0](), want, (K1_RTOL, K1_ATOL))
        check(ok, f"{k}: the library call computes the same function "
                  f"(max|d|={e:.3g})")
    del lib_out
    t = thr11.numel()
    # each kernel as a function of its inputs (the cold loop rotates
    # copies of them), with its statistic
    cold_fns = {
        "K1": (lambda a: stencil.neighbourhood_mean_cuda(a, 7, 7, mean),
               (bg0,), mean),
        "K2": (lambda a: stencil.neighbourhood_minmax_cuda(a, 7, 7, mx),
               (bg0,), mx),
        "K3": (lambda a: stencil.neighbourhood_var_cuda(a, 7, 7, std),
               (anom,), std),
        "K4": (lambda a, th: stencil.neighbourhood_quantile_fast_cuda(
                   a, 0.5, 7, 7, th), (uni, thr11), 0),
        "K5": (lambda a: stencil.neighbourhood_members_cuda(a, 7, 7, mean),
               (ens,), mean)}
    timing = {}
    for k, (kern, plain) in ms.items():
        fn, args, stat = cold_fns[k]
        timing[k] = {
            "ms": event_ms(kern), "cold_ms": cold_ms(fn, *args),
            "plain_ms": event_ms(plain, reps=10),
            "device_ms": device_ms(kern),
            "library_ms": event_ms(library[k]) if k in library else None}
        timing[k]["bound_ms"], timing[k]["bound_by"] = bound_ms(
            k, args[0].shape, 7, t if k == "K4" else 0, stat)
    ens_planes = ens.permute(2, 0, 1).contiguous()
    k1_members_ms = event_ms(lambda: [stencil.neighbourhood_mean_cuda(
        ens_planes[k], 7, 7, mean) for k in range(N_ENS)])
    del ens_planes
    k5_nan_ms = event_ms(lambda: stencil.neighbourhood_members_cuda(
        xm, 7, 7, mean))

    def fmt(v):
        return "not measured" if v is None else f"{v:.4f} ms"

    for k, r in timing.items():
        print(f"  {k} ({wrappers[k].__name__}): kernel {r['ms']:.4f} ms, "
              f"cold {r['cold_ms']:.4f} ms (device only "
              f"{fmt(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, library call "
              f"{'none' if r['library_ms'] is None else fmt(r['library_ms'])}"
              f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of the bound", flush=True)
    # the same functions at wide halfwidths, by the route the plan picks
    # (K4's only one); the bound counts the function's work, not the
    # route's scratch round trip
    wide_ms = {}
    for h in (100, 300):
        wide_fns = {
            "K1": (lambda: stencil.neighbourhood_mean_cuda(bg0, h, h, mean),
                   lambda: stencil.neighbourhood_mean_plain(bg0, h, h, mean)),
            "K2": (lambda: stencil.neighbourhood_minmax_cuda(bg0, h, h, mx),
                   lambda: stencil.neighbourhood_minmax_plain(bg0, h, h, mx)),
            "K3": (lambda: stencil.neighbourhood_var_cuda(anom, h, h, std),
                   lambda: stencil.neighbourhood_var_plain(anom, h, h, std)),
            "K4": (lambda: stencil.neighbourhood_quantile_fast_cuda(
                       uni, 0.5, h, h, thr11),
                   lambda: nops._quantile_fast_xla(uni, 0.5, h, thr11)),
            "K5": (lambda: stencil.neighbourhood_members_cuda(ens, h, h,
                                                              mean),
                   lambda: stencil.neighbourhood_members_plain(ens, h, h,
                                                               mean))}
        for k, (kern, plain) in wide_fns.items():
            _, args, stat = cold_fns[k]
            shape = args[0].shape
            route = stencil.stencil_plan(k, shape, h, h, stat, t=t).route
            b_ms, b_by = bound_ms(k, shape, h, t if k == "K4" else 0, stat)
            wide_ms[(k, h)] = {
                "ms": event_ms(kern, reps=5),
                "cold_ms": cold_ms(
                    (lambda a, th: stencil.neighbourhood_quantile_fast_cuda(
                        a, 0.5, h, h, th)) if k == "K4" else
                    (lambda a: wrappers[k](a, h, h, stat)), *args),
                "device_ms": device_ms(kern, reps=5),
                "plain_ms": event_ms(plain, reps=2),
                "bound_ms": b_ms, "bound_by": b_by, "route": route}
            r = wide_ms[(k, h)]
            # the library's pooling at h=100 (a direct (2h+1)^2 window a
            # cell; too slow to time at h=300)
            r["library_ms"] = None
            if h == 100 and k in ("K1", "K2"):
                lib = (lambda: F.avg_pool2d(bg0[None, None], 2 * h + 1, 1, h,
                                            count_include_pad=False)) \
                    if k == "K1" else (lambda: F.max_pool2d(
                        bg0[None, None], 2 * h + 1, 1, h))
                # the library sums each 201 x 201 window in one sequence
                # of 40,401 f32 adds, ~1e-5 off: a yardstick, checked at
                # rtol 1e-4
                ok, e = compare(kern(), lib()[0, 0], (1e-4, K1_ATOL))
                check(ok, f"{k} h={h}: the library call computes the same "
                          f"function (max|d|={e:.3g})")
                r["library_ms"] = event_ms(lib, reps=2)
            print(f"  {k} h={h} ({route} route): kernel {r['ms']:.4f} ms, "
                  f"cold {r['cold_ms']:.4f} ms (device only "
                  f"{fmt(r['device_ms'])}), "
                  f"plain {r['plain_ms']:.4f} ms, library call "
                  f"{'none' if r['library_ms'] is None else fmt(r['library_ms'])}"
                  f", bound {b_ms:.4f} ms ({b_by}), "
                  f"{b_ms / r['ms']:.3f} of the bound", flush=True)
            if k == "K4":
                # the wide route's two passes, device time a call
                for name, t_ms in device_ms(kern, reps=5,
                                            by_kernel=True).items():
                    print(f"    {name[:72]}: {t_ms:.4f} ms", flush=True)
    print(f"  K5 Mean 2000x2000x10 NaN-free in one launch "
          f"{timing['K5']['ms']:.4f} ms, with 10% NaN {k5_nan_ms:.4f} ms; "
          f"10 launches of K1 on contiguous member planes "
          f"{k1_members_ms:.4f} ms", flush=True)
    # K3 on EnsiPipeline's Std smoothing: the (E, Y, X) planes of the
    # ensemble's anomaly in one launch
    planes = ens.permute(2, 0, 1).contiguous() - 280.0
    k3_planes = (lambda: stencil.neighbourhood_var_cuda(planes, 7, 7, std),
                 lambda: stencil.neighbourhood_var_plain(planes, 7, 7, std))
    b_ms, b_by = bound_ms("K3", planes.shape, 7)
    kt = event_ms(k3_planes[0])
    kc = cold_ms(lambda a: stencil.neighbourhood_var_cuda(a, 7, 7, std),
                 planes)
    print(f"  K3 Std on {N_ENS} planes of 2000x2000 in one launch: kernel "
          f"{kt:.4f} ms, cold {kc:.4f} ms (device only "
          f"{fmt(device_ms(k3_planes[0]))}), plain "
          f"{event_ms(k3_planes[1], reps=5):.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / kt:.3f} of the bound", flush=True)
    del planes, k3_planes

    # -- 5. the serving path, Mean smoothing --
    lap(laps)
    print("[Pipeline 2000x2000, 10k obs, Mean h=7]", flush=True)
    p = plats.size
    grid = gt.Grid(lats, lons)
    points = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    idx = grid.nearest_map(points.lats, points.lons)
    pobs = background.reshape(-1)[idx] + noise
    ratios = np.full(p, 0.1, np.float32)
    bgs = [torch.as_tensor(background + np.float32(i), device=dev)
           for i in range(CYCLES)]
    obs = [torch.as_tensor(pobs + np.float32(i), device=dev)
           for i in range(CYCLES)]
    gap = pobs.copy()
    gap[::3] = np.nan
    gap = torch.as_tensor(gap, device=dev)
    rat = torch.as_tensor(ratios, device=dev)

    def pipeline(stat, halfwidth=7):
        t0 = time.perf_counter()
        pipe = gt.Pipeline(grid, points, gt.BarnesStructure(10000.0),
                           halfwidth=halfwidth, statistic=stat, max_points=10,
                           ratios=ratios, device=dev)
        torch.cuda.synchronize()
        print(f"  Pipeline(statistic={gt.Statistic(stat).name}, halfwidth="
              f"{halfwidth}): host set-up "
              f"{time.perf_counter() - t0:.3f} s (shortlist, tile tables, "
              "static weights)", flush=True)
        return pipe

    torch.cuda.reset_peak_memory_stats()
    pipe = pipeline(mean)
    for w in wrappers.values():
        w.launches = 0
    graph.begin_if.launches = 0
    n_cycles = run_cycles(pipe, bgs, obs, gap, rat)
    launches = {"K1": stencil.neighbourhood_mean_cuda.launches,
                "cond": graph.begin_if.launches}
    check(launches["K1"] == n_cycles,
          f"K1 launched once per cycle ({launches['K1']} launches, "
          f"{n_cycles} cycles)")
    check(launches["cond"] == CYCLES,
          f"the conditional's setter once per general replay "
          f"({launches['cond']} launches: {CYCLES - 1} cycles after the "
          "first and the obs-gap cycle)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          " GB", flush=True)
    print("  [the captured cycles: guard sequence, no host sync, "
          "serve_stream, profile]", flush=True)
    traces = graph_checks(gt, stencil, dev, pipe, background, pobs, ratios)
    cond_k = cond_entry(launches["cond"], traces)
    del pipe

    lap(laps)
    print("[Pipeline 2000x2000, 10k obs, Mean h=100: K1's wide route]",
          flush=True)
    pipe = pipeline(mean, 100)
    for w in wrappers.values():
        w.launches = w.wide = 0
    n_cycles = run_cycles(pipe, bgs, obs, gap, rat)
    wide_launches = stencil.neighbourhood_mean_cuda.wide
    check(stencil.neighbourhood_mean_cuda.launches == n_cycles
          and wide_launches == n_cycles,
          f"h=100: K1 called once per cycle, by the wide route "
          f"({stencil.neighbourhood_mean_cuda.launches} calls, "
          f"{wide_launches} wide, {n_cycles} cycles)")

    # -- 6. the neighbourhood-statistics path --
    lap(laps)
    print("[neighbourhood statistics: Pipeline Max h=7, Std, quantile_fast, "
          "members]", flush=True)
    del pipe
    pipe = pipeline(mx)
    for w in wrappers.values():
        w.launches = 0
    n_cycles = run_cycles(pipe, bgs, obs, gap, rat)
    k2_pipe = stencil.neighbourhood_minmax_cuda.launches
    check(k2_pipe == n_cycles,
          f"K2 launched once per cycle ({k2_pipe} launches, {n_cycles} "
          "cycles)")
    del pipe
    # Std on the field's anomaly: E[x^2] - E[x]^2 of a 280 K field cancels
    # most of f32's digits in any implementation
    print("  [Pipeline Std h=7 on the anomaly]", flush=True)
    pipe = pipeline(std)
    n_cycles = run_cycles(pipe, [b - 280.0 for b in bgs],
                          [o - 280.0 for o in obs], gap - 280.0, rat)
    k3_pipe = stencil.neighbourhood_var_cuda.launches
    check(k3_pipe == n_cycles,
          f"K3 launched once per cycle ({k3_pipe} launches, {n_cycles} "
          "cycles)")
    stencil.neighbourhood_quantile_fast_cuda.wide = 0
    t0 = time.perf_counter()
    sd = nops.neighbourhood(anom, 7, std)
    qf = nops.neighbourhood_quantile_fast(uni, 0.5, 7, thr11)
    qf_wide = nops.neighbourhood_quantile_fast(uni, 0.5, 100, thr11)
    mem = stencil.neighbourhood_members(xm, 7, mean)
    torch.cuda.synchronize()
    print(f"  Std + quantile_fast (h=7, h=100) + members: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches.update({k: wrappers[k].launches for k in ("K2", "K3", "K4",
                                                       "K5")})
    k4_wide = stencil.neighbourhood_quantile_fast_cuda.wide
    check(k4_wide == 2 == launches["K4"], f"quantile_fast h=7 and h=100 "
          f"each took K4's wide route once ({launches['K4']} launches, "
          f"{k4_wide} wide)")
    for k in ("K2", "K3", "K4", "K5"):
        check(launches[k] >= 1, f"{k} launched on the path "
                                f"({launches[k]} launches)")
    check(bool(torch.isfinite(sd).all()) and sd.shape == (2000, 2000),
          "Std: finite, (2000, 2000)")
    check(bool(((qf >= 0) & (qf <= 1)).all())
          and bool(((qf_wide >= 0) & (qf_wide <= 1)).all()),
          "quantile_fast h=7 and h=100: in [0, 1]")
    check(bool(torch.isfinite(mem).any(dim=-1).all())
          and mem.shape == (2000, 2000, 10), "members: (2000, 2000, 10)")

    # -- 7. ensemble OI --
    lap(laps)
    print(f"[ensemble OI 2000x2000x{N_ENS}, 10k obs: EnsiPipeline, "
          "MultiEnsiPipeline]", flush=True)
    del pipe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches["K5"], k3_ensi, ens_np, ens_structure = ensemble_phase(
        gt, stencil, dev, grid, points, background.reshape(-1)[idx], obs,
        gap, ratios)
    launches["K3"] += k3_ensi
    print(f"  ensemble phase {time.perf_counter() - t0:.3f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB",
          flush=True)

    # -- 8. card against CPU --
    lap(laps)
    print("[card vs CPU, 256x256 cut]", flush=True)
    m = 256
    inside = ((plats >= lats[0, 0]) & (plats <= lats[m - 1, 0])
              & (plons >= lons[0, 0]) & (plons <= lons[0, m - 1]))
    print(f"  {int(inside.sum())} obs in the cut", flush=True)
    g2 = gt.Grid(lats[:m, :m], lons[:m, :m])
    pts2 = gt.Points(plats[inside], plons[inside], np.zeros(inside.sum()),
                     np.zeros(inside.sum()))
    sub_bg = background[:m, :m]
    po2 = (sub_bg.reshape(-1)[g2.nearest_map(pts2.lats, pts2.lons)]
           + noise[inside])
    for stat in (mean, mx, std):
        # Std smooths the anomaly: E[x^2] - E[x]^2 of the 280 K field
        # cancels most of f32's digits in any implementation
        shift = np.float32(280.0 if stat == std else 0.0)
        sub = {}
        for d in (dev, torch.device("cpu")):
            pipe2 = gt.Pipeline(g2, pts2, gt.BarnesStructure(10000.0),
                                halfwidth=7, statistic=stat, max_points=10,
                                ratios=ratios[inside], device=d)
            sub[d.type] = {path: pipe2.run_device(
                torch.as_tensor(sub_bg - shift, device=d),
                torch.as_tensor(po2 - shift, device=d), ratios[inside],
                path=path).cpu() for path in ("fast", "general", "resolve")}
        for path in sub["cuda"]:
            d = float((sub["cuda"][path] - sub["cpu"][path]).abs().max())
            check(d <= CARD_CPU_TOL, f"{gt.Statistic(stat).name} {path}: "
                                     f"card vs CPU max|d|={d:.3g}")
    ens2 = np.ascontiguousarray(ens_np[:m, :m])
    k = int(inside.sum())
    pe2 = (ens2.reshape(-1, N_ENS)[g2.nearest_map(pts2.lats, pts2.lons)]
           + np.random.default_rng(4).normal(0, 1, (k, N_ENS))).astype(
        np.float32)
    st2 = gt.BarnesStructure(10000.0)
    for name, kw in (("ensi", dict(halfwidth=0)),
                     ("ensi", dict(halfwidth=7,
                                   statistic=gt.Statistic.Mean)),
                     ("ebesc", dict(variant="ebesc")),
                     ("ebe", dict(variant="ebe")),
                     ("utem", dict(variant="utem"))):
        sub = {}
        for d in (dev, torch.device("cpu")):
            if name == "ensi":
                pipe2 = gt.EnsiPipeline(g2, pts2, st2, max_points=10,
                                        device=d, **kw)
                host = (ens2, po2, np.full(k, 1.5, np.float32))
            else:
                pipe2 = gt.MultiEnsiPipeline(g2, pts2, st2, max_points=10,
                                             device=d, **kw)
                host = (ens2, po2 if name == "utem" else pe2,
                        ratios[inside]) + (() if name == "ebesc"
                                           else (ens2,))
            sub[d.type] = pipe2.run_device(
                *(torch.as_tensor(a, device=d) for a in host))[0].cpu()
        d = float((sub["cuda"] - sub["cpu"]).abs().max())
        label = ", ".join(f"{k}={getattr(v, 'name', v)}"
                          for k, v in kw.items())
        check(bool(torch.isfinite(sub["cuda"]).all())
              and d <= ENS_CARD_CPU_TOL[name],
              f"{name} ({label}): card vs CPU max|d|={d:.3g}")

    # -- 9. gridpp's OI API on the card --
    lap(laps)
    print(f"[gridpp OI API 2000x2000, 10k obs, {N_ENS} members: device "
          "route]", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    api_phase(gt, dev, grid, points, ens_structure, background, pobs,
              ratios, idx, ens_np,
              (g2, pts2, st2, np.ascontiguousarray(sub_bg), po2.astype(
                  np.float32), ens2, pe2, ratios[inside]))
    print(f"  API phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 10. downscale, gradient-correct, calibrate --
    lap(laps)
    print(f"[downscale {MEPS_SHAPE[0]}x{MEPS_SHAPE[1]}x{N_LEAD} -> 2000x2000 "
          f"and {plats.size} points, gradients, curves: device route]",
          flush=True)
    del ens_np
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lr_k1 = downscale_phase(gt, dev, lats, lons, plats, plons)
    print(f"  downscale phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 11. the rest of gridpp's numpy API --
    lap(laps)
    print("[gridpp numpy API 2000x2000, 10k points: LDC, search, smart, "
          "window, masking, diagnostics, verification: device route]",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    score_k1 = api_slice_phase(gt, dev, lats, lons, plats, plons)
    print(f"  API slice phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 12. the parallel layer --
    lap(laps)
    print(f"[parallel 2000x2000, {plats.size} obs: one NCCL rank, "
          f"{PAR_RANKS} gloo ranks on the card, the sharded stencil]",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parallel_k = parallel_phase(gt, dev)
    print(f"  parallel phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 13. the command-line client --
    lap(laps)
    print(f"[python -m gridpp_tpu_torch: MEPS {MEPS_SHAPE[0]}x{MEPS_SHAPE[1]}"
          f"x{N_LEAD} -> 2000x2000, bilinear + neighbourhood Mean, Max, Std "
          f"h={CLI_H}; -c oi on a {CLI_OI_CUT}^2 cut]", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_k = cli_phase(gt, dev, lats, lons, plats, plons)
    print(f"  CLI phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 14. the port's tools --
    lap(laps)
    print("[gridpp_tpu_torch.tools: the all-API smoke, the parity sweep, "
          "the per-operator table, the scaling harness]", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tools_k = tools_phase(gt, dev)
    print(f"  tools phase {time.perf_counter() - t0:.3f} s", flush=True)

    # -- 15. the roofline --
    lap(laps)
    print("[gridpp_tpu_torch.tools.roofline: every kernel and OI block, "
          "warm and cold, against its bound]", flush=True)
    torch.cuda.empty_cache()
    roofline_phase(dev)

    # -- 16. the benchmark tool --
    lap(laps)
    print("[python -m gridpp_tpu_torch.tools.bench: bench.py's run on the "
          "card; serve_stream's overlap in a trace]", flush=True)
    torch.cuda.empty_cache()
    bench_k = bench_phase(gt, dev, t_start)
    lap(laps)
    print(f"  the script {time.perf_counter() - t_start:.3f} s; each phase "
          f"(the build first): "
          f"{', '.join(f'{b - a:.1f}' for a, b in zip(laps[1:], laps[2:]))} "
          "s", flush=True)

    sources = {"K1": ("neighbourhood_mean", f"{PALLAS}:301"),
               "K2": ("neighbourhood_minmax", f"{PALLAS}:364"),
               "K3": ("neighbourhood_var", f"{PALLAS}:330"),
               "K4": ("neighbourhood_wide", f"{PALLAS}:465"),
               "K5": ("neighbourhood_members", f"{PALLAS}:643")}
    kernels = [{
        "name": wrappers[k].__name__,
        "route": "cuda",
        "source": f"gridpp_tpu_torch/csrc/{sources[k][0]}.cu",
        "replaces": sources[k][1],
        "launches": launches[k],
        "max_abs_err": err[k],
        **timing[k]} for k in wrappers]
    # the wide route on the main path: K1's, in phase 5's h=100 cycles
    kernels.append({
        "name": "neighbourhood_mean_cuda (wide route, nbw_launch)",
        "route": "cuda",
        "source": "gridpp_tpu_torch/csrc/neighbourhood_wide.cu",
        "replaces": f"{PALLAS}:301",
        "launches": wide_launches,
        "max_abs_err": wide_err,
        **{key: wide_ms[("K1", 100)][key]
           for key in ("ms", "cold_ms", "device_ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")}})
    # K1 on the downscale phase's path, with that path's own launches
    kernels.append(lr_k1)
    # K1 on neighbourhood_score's path (phase 11), at each halfwidth
    kernels.extend(score_k1)
    # K1 on the distributed step's padded tile, K2 and K3 on the sharded
    # stencil's tiles (phase 12); K1, K2 and K3 in the CLI (phase 13); K1,
    # K2 and K4 in the per-operator table (phase 14)
    kernels.extend(parallel_k + cli_k + tools_k)
    # K1 on the benchmark tool's Pipeline cycles and serve_stream (phase 16)
    kernels.append(bench_k)
    # the general graph's conditional node (phase 5), the setter's launches
    # those of phase 5's general replays
    kernels.append(cond_k)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
