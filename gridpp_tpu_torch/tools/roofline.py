"""Roofline of gridpp_tpu_torch's hand-written kernels and OI blocks on the
card: the counterpart of tools/roofline.py.

    python -m gridpp_tpu_torch.tools.roofline [--trace DIR]
        [--device cuda|cpu] [--scale F]

For each row (`rows`: the reference tool's eight, then one for each kernel
of ops.stencil.KERNELS that those leave without one, at the main path's
sizes) it combines the work that `count` gives from the row's shapes with
the row's time on the card:

- warm: ITERS chained launches on one input (the output fed back as the
  first argument where it has its shape, as the reference chains its
  dispatches), the input hot in the L2 cache;
- cold: launches rotated over enough distinct copies of the inputs to
  pass COLD_BYTES, so each launch finds its input outside the 50 MB L2
  (one copy where the input alone is at least twice the L2);
- device: the warm loop's kernel time from torch.profiler, where a trace
  shows at least half the warm time (taken up to three times);
- library: where one PyTorch call computes the same function (K1, K2,
  K5 and their wide route: avg_pool2d / max_pool2d), that call, cold.

From these: GOP/s and GB/s (io) at the cold time, operations per byte,
the bound (`bound`: the larger of the bytes over the card's memory rate
and the operations over its peak rate for their type, from `peaks`), the
share of that bound and the io rate's share of `measured_bw()`. Before
a row is timed its output is held once against its plain version at the
kernel's bar (PERF.md section 2): the stencils against their `*_plain`
versions on the card, the OI blocks against the same function on the
CPU. A row whose kernel does not launch, or a kernel of
ops.stencil.KERNELS that no row launches, fails the run.

--device cpu runs the plain versions on the CPU: it prints the counts and
CPU times (`cpu_*` keys) and writes every device column "not measured".
There is no CPU fallback on the card: a card row runs its kernel or
raises. The last line is a JSON list of the rows.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Row", "Work", "rows", "count", "parts", "terms", "sources", "peaks",
           "measured_bw", "bound", "cold_ms", "characterize", "run",
           "table", "main"]

# the reference's chain of dispatches a warm row; fewer where a call is
# slow (WARM_S of launches at most, and at least MIN_ITERS)
ITERS, MIN_ITERS, WARM_S = 300, 3, 0.25
# calls a row's profiler trace takes
PROFILE_ITERS = 20
# an H100's L2 cache, the bytes a cold loop rotates through and the most
# copies it makes (an OI block's 0.6 MB of inputs at scale 1 take 406)
L2_BYTES = 50 * 2**20
COLD_BYTES = 256 * 2**20
MAX_COPIES = 512
# output rows that the wide route's column fold shares its window's core
# between (kRun, csrc/neighbourhood_wide.cu)
WIDE_RUN = 16
# the bars of PERF.md section 2: a stencil against its plain version on
# the card (None: equal), an OI block on the card against the CPU
K1_BAR = (1e-5, 1e-4)            # tests/test_pallas_stencil.py:36-38
K3_BAR = (2e-5, 2e-3)            # tests/test_pallas_stencil.py:220
OI_BAR = (0.0, 1e-3)             # card vs CPU, Pipeline and ebe/ebesc
ENSI_BAR = (0.0, 2e-3)           # EnSI: kernel vs chain, card vs CPU
# the EnSI chain on the card is held to the CPU's up to this many rows
PLAIN_CHECK_ROWS = 1 << 16
# a library call against the kernel at a wide window: the library sums
# each (2h+1)^2 window in one sequence of f32 adds
WIDE_LIBRARY_BAR = (1e-4, 1e-4)
NOT_MEASURED = "not measured"
# the columns of a row that hold device numbers
DEVICE_KEYS = ("warm_ms", "cold_ms", "device_ms", "library_ms", "bound_ms",
               "gops_s", "gbytes_s", "pct_peak", "pct_measured_bw")

# Published peaks by card (NVIDIA's data sheets, dense, at the card's
# full power limit): HBM bytes/s and f32 operations/s outside the tensor
# cores; the SM issues int32 at half the f32 rate. Matched in order
# against torch.cuda.get_device_name().
PEAKS = (
    ("H100 NVL", {"bytes": 3.9e12, "f32": 60e12, "int32": 30e12},
     "NVIDIA H100 NVL data sheet"),
    ("H100 PCIe", {"bytes": 2.0e12, "f32": 51e12, "int32": 25.5e12},
     "NVIDIA H100 PCIe data sheet"),
    ("H100", {"bytes": 3.35e12, "f32": 67e12, "int32": 33.5e12},
     "NVIDIA H100 SXM5 data sheet"),
)


class Row(NamedTuple):
    """One row: `kind` is a kernel ("K1"-"K5") or an OI block ("ensi",
    "oi", "tiled"); `shape` its sizes (K1-K3 (Y, X) or (B, Y, X), K4 (Y,
    X), K5 (Y, X, E); ensi (B, S, E, P); oi (B, P, S); tiled (Y, X, P, S,
    K, T, TB, C, F), see `count`); h the clipped halfwidth, t the thresholds,
    stat the statistic; plain: the row runs the port's plain version;
    uniform: a K1/K2 row's field is uniform [0, 1) (the reference's rows),
    not the benchmark background normal(280, 5)."""
    label: str
    kind: str
    shape: tuple
    h: int = 0
    t: int = 0
    stat: int = 0
    plain: bool = False
    uniform: bool = False


def _prod(shape):
    return math.prod(int(d) for d in shape)


def terms(h: int) -> float:
    """Terms a cell and pass of a separable (2h+1)-wide window sum or
    extremum needs at least: the direct window's 2h+1 while it is
    narrower than WIDE_RUN rows, else a fold that shares each window's core
    between WIDE_RUN outputs, (2 WIDE_RUN + 2h) / WIDE_RUN."""
    k = 2 * h + 1
    return float(k) if k < WIDE_RUN else (2 * WIDE_RUN + 2 * h) / WIDE_RUN


def _select(rows, width, s):
    """(elementwise, reduction) operations of ops.oi._select_top on
    (rows, width): a masked copy, then either one stable sort (width <=
    _SORT_WIDTH) or _top_index's six passes that build a unique int64
    key and one top-k; isfinite of the s kept."""
    from ..ops.oi import _SORT_WIDTH
    key = 6 if width > _SORT_WIDTH else 0
    return rows * width * (1 + key) + rows * s, rows * width


def _solve(b, s):
    """Elementwise operations of ops.oi._solve_weights on b rows of s
    selected obs, BarnesStructure's corr_torch included: 39 a pair and 2
    a point and side (`_pair`); the pair mask, ridge and matrix 6 a pair;
    the ridge's select and the masked gain 2 a slot; eye > 0; the
    unpivoted Gauss-Jordan's s steps of (s + 1)(2s + 1) a row."""
    pair, side = _pair()
    return (b * s * s * (pair + 6) + 2 * side * b * s + 2 * b * s + s * s
            + s * b * (s + 1) * (2 * s + 1))


def _pair():
    """BarnesStructure's corr_torch (structure.py, scalar h, v, w) on one
    pair: the distance 9 (3 subtractions, 3 squares, 2 adds, sqrt), the
    horizontal kernel 6 (divide, 2 multiplies, exp, isfinite, select),
    each of the elevation and laf factors 11 (the joint isfinite, the
    difference and its select, the kernel's 6, the factor's select and
    multiply), the localization 2; and isfinite once a point for each of
    the two factors. Returns (39, 2)."""
    return 9 + 6 + 2 * 11 + 2, 2


def _ns_steps():
    """Matrix products and elementwise passes of ops.oi_ensi._inv_sqrt_ns
    from its coefficient schedule: step i forms t = sym(z y) (not at step
    0), q = a I + b t [+ c t t], y = y q (not at the last step) and z = q z
    (not at step 0). Returns (products, (B, E, E) passes, (E, E)
    passes)."""
    from ..ops.oi_ensi import _NS_COEFFS
    n = len(_NS_COEFFS)
    n_c = sum(1 for c in _NS_COEFFS if c[2])
    products = 2 * (n - 1) + n_c + (n - 1)
    # abs, the normalised sym(A), each later t's sym, q's scale and add,
    # c t t's scale and add, and the final sym
    passes = 1 + 3 + 2 * (n - 1) + 2 * n + 2 * n_c + 2
    return products, passes, n


class Work(NamedTuple):
    """A row's bytes, and its operations by kind: matrix products,
    elementwise passes and reductions; `peak` names the rate that bounds
    them ("f32" or "int32")."""
    bytes: int
    products: float
    elementwise: float
    reductions: float
    peak: str


def count(row: Row):
    """(bytes, operations, "f32" or "int32") of a row's function, from its
    shapes alone (`parts`, its operations summed): the only count of a
    bound in the port."""
    w = parts(row)
    return w.bytes, w.products + w.elementwise + w.reductions, w.peak


def parts(row: Row) -> Work:
    """The Work of a row's function, from its shapes alone.

    Bytes: each input read once and each output written once (f32 4
    bytes, bool 1, int64 8). Operations: each elementwise arithmetic,
    compare, select or cast one an element it writes; each reduction,
    sort or top-k one an element it reads; a matrix product 2 m n k.

    - K1, K2, K3 on (Y, X) or (B, Y, X) cells, K5 on (Y, X, E): one f32
      read and one write a cell; operations 4 (K1, K5 Mean: the sums and
      counts of the two passes), 2 (K2: the extrema) or 6 (K3: sums, sums
      of squares and counts) a term, `terms(h)` terms a cell.
    - K4 on (Y, X) with t thresholds: the field and thresholds read, the
      field written; int32 operations a cell: 2 (t + 1) indicator
      compares and adds, 4 a packed word of running counts (qf_words, at
      the lane width the window's cells need), 3 t for each threshold's
      prefix difference, test and interpolation.
    - ensi (B, S, E, P): the EnSI update of B rows with
      allow_extrapolation (ops.oi_ensi.ensi_update_cuda, the kernel, or
      its plain version ensi_update_plain), inputs the background (B, E),
      validity (B, S, bool), rho (B, S), the obs index g (B, S, int64) and
      the packed table of P obs (P, 3 + E); output (B, E). Products, the
      real FMA count the kernel issues: Pinv = C Y 2 B E^2 S, the
      Newton-Schulz iteration's E x E products (`_ns_steps`: 34 for ten
      steps) 2 B E^3 each, C innov 2 B E S, six E x E matrix-vector
      products 2 B E^2 each. Elementwise: 5 B S (Rinv,
      innovations), B E S (C), (3 + NS passes + 2) B E^2 (the
      symmetrised Pinv and its ridge, the iteration, isfinite of Pinv and
      z), (1 + n) E^2, 11 B E, 11 B; reductions 3 B E^2 + 4 B E + B S.
    - oi (B, P, S): ops.oi.oi_block_dense with BarnesStructure and
      allow_extrapolation, inputs background, bvariance and 5 point fields
      (B), 5 obs fields, obs, obs_y, ratios (P); output (B,). Elementwise:
      the structure on every pair (`_pair`) and rho > 0, 1 B P, the
      selection (`_select`), the S x S solve (`_solve`), 5 B S and 9 B
      for the gain mask, the innovations, the increment and the variance;
      reductions B P (selection) and 4 B S.
    - tiled (Y, X, P, S, K, T, TB, C, F): a Pipeline(tiled=True)'s
      re-solve as tools/roofline.py's tiled row runs it (`tiled_fn`) on
      N = Y X gridpoints, P obs, S = max_points of K shortlist
      candidates, T tiles of TB gridpoints, C union slots and F static
      fields a slot; inputs the background (N), obs and ratios (P), the
      obs' nearest gridpoint (P, int64), the tile table (T, C, int32),
      local slots and rho (T, TB, K: int32, f32), validity (T, TB, K,
      bool), static fields (T, C, F); output (N). Elementwise: 8 P (the
      obs' validity and packing), 1 P innovations, per gridpoint N' = T
      TB of the weights 4 K (the page's cast and offset, validity test
      and mask) + the selection + 1 S (lg) + the solve + 1 S (x lg), of
      the apply 4 S (the page's cast and offset, mask, x innov) + 4, of
      the variance 5; casts of the tile table 2 T C, page offsets 2 T;
      reductions N' K (the sort) + 4 N' S (the gain's and the
      increment's sums, the apply's and the variance's any)."""
    kind, shape = row.kind, tuple(int(d) for d in row.shape)
    if kind in ("K1", "K2", "K3", "K5"):
        cells = _prod(shape)
        per = {"K1": 4, "K2": 2, "K3": 6}.get(kind)
        if kind == "K5":
            from ..ops.stencil import MINMAX_STATS
            per = 2 if int(row.stat) in MINMAX_STATS else 4
        return Work(8 * cells, 0, per * terms(row.h) * cells, 0, "f32")
    if kind == "K4":
        from ..ops.stencil import qf_lane_bits, qf_words
        ny, nx = shape
        cells, t = ny * nx, int(row.t)
        window = min(2 * row.h + 1, ny) * min(2 * row.h + 1, nx)
        words = qf_words(t, qf_lane_bits(window))
        return Work(8 * cells + 4 * t, 0,
                    cells * (2 * (t + 1) + 4 * words + 3 * t), 0, "int32")
    if kind == "ensi":
        b, s, e, p = shape
        products, passes, n = _ns_steps()
        mm = 2 * b * (e * e * s + products * e ** 3 + e * s + 6 * e * e)
        ew = (5 * b * s + b * e * s + (3 + passes + 2) * b * e * e
              + (1 + n) * e * e + 11 * b * e + 11 * b)
        red = 3 * b * e * e + 4 * b * e + b * s
        nbytes = (8 * b * e + b * s + 4 * b * s + 8 * b * s
                  + 4 * p * (3 + e))
        return Work(nbytes, mm, ew, red, "f32")
    if kind == "oi":
        b, p, s = shape
        pair, side = _pair()
        sel_ew, sel_red = _select(b, p, s)
        ew = (b * p * (pair + 1) + side * (b + p) + sel_ew + _solve(b, s)
              + 5 * b * s + 9 * b)
        red = sel_red + 4 * b * s
        return Work(4 * (7 * b + 8 * p) + 4 * b, 0, ew, red, "f32")
    if kind == "tiled":
        ny, nx, p, s, k, t, tb, c, f = shape
        n, n_t = ny * nx, t * tb
        sel_ew, sel_red = _select(n_t, k, s)
        ew = (9 * p + n_t * (4 * k + 2 * s) + sel_ew + _solve(n_t, s)
              + n_t * (4 * s + 4) + 5 * n_t + 2 * t * c + 2 * t)
        red = sel_red + 4 * n_t * s
        nbytes = (4 * n + 8 * p + 8 * p + 4 * t * c + 9 * n_t * k
                  + 4 * t * c * f + 4 * n)
        return Work(nbytes, 0, ew, red, "f32")
    raise ValueError(f"no count for row kind {kind!r}")


def sources(row: Row) -> set:
    """The csrc sources (ops.stencil.KERNELS keys) whose kernels a card row
    launches: a kernel row's, by the route stencil_plan picks from its
    shapes; the EnSI transform's for an EnSI update row; none for a plain
    or other OI row."""
    from ..ops import stencil
    if row.kind == "ensi" and not row.plain:
        return {"ensi_transform"}
    if row.plain or row.kind not in ("K1", "K2", "K3", "K4", "K5"):
        return set()
    plan = stencil.stencil_plan(row.kind, row.shape, row.h, row.h,
                                row.stat, t=row.t)
    if plan.route == "wide":
        return {"neighbourhood_wide"}
    return {{"K1": "neighbourhood_mean", "K2": "neighbourhood_minmax",
             "K3": "neighbourhood_var",
             "K5": "neighbourhood_members"}[row.kind]}


def peaks(device=None):
    """(name, peaks, source) of the card's published peaks (PEAKS), or
    None where the card is not in the table or there is no card."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, p, src in PEAKS:
        if key in name:
            return name, p, src
    return None


def measured_bw(device="cuda") -> float:
    """The card's achievable memory rate (bytes/s), measured: the best of
    3 runs of 8 torch.add(x, 1.0, out=y) on 8192^2 f32 (one read and one
    write, the stencils' traffic), by CUDA events."""
    x = torch.ones((8192, 8192), device=device)
    y = torch.empty_like(x)
    torch.add(x, 1.0, out=y)
    clock = _Clock(x.device)
    best = 0.0
    for _ in range(3):
        clock.start()
        for _ in range(8):
            torch.add(x, 1.0, out=y)
        best = max(best, 8 * 2 * x.nbytes / (clock.stop() / 1e3))
    return best


def bound(work, rates) -> tuple:
    """(ms, "bytes" or "operations"): the least time of `work` (count's
    (bytes, operations, peak name)) at `rates` (a PEAKS entry's dict)."""
    nbytes, ops, peak = work
    t_bytes, t_ops = nbytes / rates["bytes"], ops / rates[peak]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- timing -------------------------------------------------------------------
def _tensors(a):
    """The tensors in a (nested tuples, lists and dicts of) argument."""
    if isinstance(a, torch.Tensor):
        yield a
    elif isinstance(a, dict):
        for v in a.values():
            yield from _tensors(v)
    elif isinstance(a, (list, tuple)):
        for v in a:
            yield from _tensors(v)


def _map(fn, a):
    """a with fn applied to each of its tensors."""
    if isinstance(a, torch.Tensor):
        return fn(a)
    if isinstance(a, dict):
        return {k: _map(fn, v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_map(fn, v) for v in a)
    return a


def _nbytes(a) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(a))


class _Clock:
    """Elapsed ms between start() and stop(): CUDA events on the card
    (after a synchronise), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device

    def start(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            self.ev[0].record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize(self.device)
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t) * 1e3


def _iters(fn, args, device) -> int:
    """ITERS, or as many calls as fit WARM_S at one call's time (at least
    MIN_ITERS), after a warm-up call."""
    fn(*args)
    clock = _Clock(device)
    clock.start()
    fn(*args)
    one = clock.stop() / 1e3
    return max(MIN_ITERS, min(ITERS, int(WARM_S / max(one, 1e-9))))


def warm_ms(fn, args, iters, device) -> float:
    """Mean ms a call over `iters` chained calls on one input: the output
    is fed back as the first argument where it has that tensor's shape
    and type."""
    args = list(args)
    head = args[0]
    clock = _Clock(device)
    clock.start()
    cur = head
    for _ in range(iters):
        out = fn(cur, *args[1:])
        if isinstance(head, torch.Tensor) and isinstance(out, torch.Tensor) \
                and out.shape == head.shape and out.dtype == head.dtype:
            cur = out
    return clock.stop() / iters


def cold_ms(fn, args, iters=None, device=None) -> float:
    """Mean ms a call of fn(*args) with the inputs outside the L2 cache:
    calls rotated over copies of args, as many as pass COLD_BYTES (one
    where the inputs alone are at least twice L2_BYTES; at most
    MAX_COPIES), after a warm-up call; `iters` calls (default: as `_iters`
    picks), at least one a copy."""
    if device is None:
        device = next(a.device for a in _tensors(args))
    device = torch.device(device)
    size = max(_nbytes(args), 1)
    n = 1 if size >= 2 * L2_BYTES else min(MAX_COPIES,
                                              -(-COLD_BYTES // size))
    if iters is None:
        iters = _iters(fn, args, device)
    copies = [args] + [_map(torch.clone, args) for _ in range(n - 1)]
    iters = max(iters, n)
    fn(*copies[-1])
    clock = _Clock(device)
    clock.start()
    for i in range(iters):
        fn(*copies[i % n])
    ms = clock.stop() / iters
    del copies
    return ms


def device_ms(fn, args, iters, at_least=0.0, trace=None):
    """Mean kernel ms a call over `iters` chained calls from
    torch.profiler's CUDA activity; a trace below `at_least` ms a call (a
    partial one: back-to-back single launches can lose theirs) is taken
    again, three times in all, and None (not measured) when none reaches
    it. The last trace is written to `trace` when given."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    device = next(a.device for a in _tensors(args))
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            warm_ms(fn, args, iters, device)
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        ms = total / iters / 1e3
        if ms > 0 and ms >= at_least:
            break
    if trace:
        prof.export_chrome_trace(trace)
    return ms if ms > 0 and ms >= at_least else None


# -- rows ---------------------------------------------------------------------
def _side(n, scale):
    return max(8, int(round(n * scale)))


def rows(scale: float = 1.0) -> list:
    """The rows at `scale` (each side, batch and obs count scaled; E, S,
    T and the halfwidths kept, halfwidths clipped to the grid): first the
    reference tool's eight (its [xla] rows as [plain] rows, the port's
    plain versions; its EnSI update row the EnSI kernel), then the EnSI
    update's plain chain beside it, the kernel and the chain at the
    ensemble cell's block of 2^20 rows (10,000 obs), then one row for
    each stencil kernel and the wide route at the main path's sizes
    (2000^2, h=7, T=11, 10 members; the wide route at h=100). The tiled
    row's shape is completed by `make`, from its Pipeline's tables."""
    from ..constants import Statistic
    mean, mx, std = int(Statistic.Mean), int(Statistic.Max), \
        int(Statistic.Std)
    n2k, n2 = _side(2048, scale), _side(2000, scale)
    b, p = _side(16384, scale), _side(4096, scale)
    n_t = _side(512, scale)
    b_cell, p_ens = _side(1 << 20, scale), _side(10000, scale)

    def clip(h, n):
        return min(h, n - 1)

    h2k, h7, h100 = clip(7, n2k), clip(7, n2), clip(100, n2)
    out = [
        Row(f"neighbourhood mean {n2k}^2 h={h2k}", "K1", (n2k, n2k), h2k,
            stat=mean, uniform=True),
        Row(f"neighbourhood max {n2k}^2 h={h2k}", "K2", (n2k, n2k), h2k,
            stat=mx, uniform=True),
        Row(f"quantile_fast {n2k}^2 T=11", "K4", (n2k, n2k), h2k, 11),
        Row(f"neighbourhood mean {n2k}^2 h={h2k} [plain]", "K1",
            (n2k, n2k), h2k, stat=mean, plain=True, uniform=True),
        Row(f"quantile_fast {n2k}^2 T=11 [plain]", "K4", (n2k, n2k), h2k,
            11, plain=True),
        Row(f"EnSI update B={b} E=10 S=10", "ensi", (b, 10, 10, p_ens)),
        Row(f"OI dense block B={b} P={p} S=10", "oi", (b, p, 10)),
        Row(f"OI tiled general sweep {n_t}^2 {p} obs S=10", "tiled",
            (n_t, n_t, p, 10)),
        Row(f"EnSI update B={b} E=10 S=10 [plain]", "ensi",
            (b, 10, 10, p_ens), plain=True),
        Row(f"EnSI update B={b_cell} E=10 S=10", "ensi",
            (b_cell, 10, 10, p_ens)),
        Row(f"EnSI update B={b_cell} E=10 S=10 [plain]", "ensi",
            (b_cell, 10, 10, p_ens), plain=True),
    ]
    for h, tag in ((h7, ""), (h100, "wide ")):
        out += [
            Row(f"{tag}K1 mean {n2}^2 h={h}", "K1", (n2, n2), h, stat=mean),
            Row(f"{tag}K2 max {n2}^2 h={h}", "K2", (n2, n2), h, stat=mx),
            Row(f"{tag}K3 std {n2}^2 h={h}", "K3", (n2, n2), h, stat=std),
            Row(f"{tag}K4 quantile_fast {n2}^2 T=11 h={h}", "K4", (n2, n2),
                h, 11),
            Row(f"{tag}K5 members mean {n2}^2x10 h={h}", "K5",
                (n2, n2, 10), h, stat=mean),
        ]
    return out


def tiled_fn(structure, geom, static_keys, max_points):
    """The tiled row's function, as tools/roofline.py's make_tiled builds
    it: fn(background (Y, X), obs (P,), ratios (P,), the device geometry
    dict, the obs' nearest gridpoint (P,)) -> the (Y, X) analysis of
    oi_tiled_sweep, the full re-solve."""
    from ..ops import oi_tiled

    def fn(background, pobs, pratios, gd, obs_nn):
        flat = background.reshape(-1)
        pback = flat[obs_nn]
        valid01 = (torch.isfinite(pobs)
                   & torch.isfinite(pback)).to(torch.float32)
        packed = torch.stack([torch.where(valid01 > 0, pobs, 0.0),
                              torch.where(valid01 > 0, pback, 0.0),
                              pratios, valid01], dim=1)
        bg_t = oi_tiled.tile_fields(background, geom)
        out_t, _ = oi_tiled.oi_tiled_sweep(
            structure, gd, static_keys, bg_t, torch.ones_like(bg_t), packed,
            max_points, True)
        return oi_tiled.untile_fields(out_t, geom).reshape(background.shape)
    return fn


class Made(NamedTuple):
    """A row made on a device: fn(*args) the timed call; plain(*args) the
    function it is held to (on `check_device`, None: not checked) at
    `bar`; library(*args) one PyTorch call of the same function or None;
    wrapper: the kernel wrapper whose launches the row counts (None: not
    a kernel row)."""
    row: Row
    fn: object
    args: tuple
    plain: object = None
    bar: object = None
    check_device: object = None
    library: object = None
    library_bar: object = None
    wrapper: object = None


def make(row: Row, device, rng) -> Made:
    """The row's call and inputs on `device` (seeded from rng): on the
    card a kernel row calls its wrapper, on the CPU its plain version."""
    import gridpp_tpu_torch as gt
    from ..ops import neighbourhood as nops
    from ..ops import stencil
    device = torch.device(device)
    cuda = device.type == "cuda"
    h, kind = row.h, row.kind

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    if kind in ("K1", "K2", "K3", "K5"):
        wrapper, plain, bar = {
            "K1": (stencil.neighbourhood_mean_cuda,
                   stencil.neighbourhood_mean_plain, K1_BAR),
            "K2": (stencil.neighbourhood_minmax_cuda,
                   stencil.neighbourhood_minmax_plain, None),
            "K3": (stencil.neighbourhood_var_cuda,
                   stencil.neighbourhood_var_plain, K3_BAR),
            "K5": (stencil.neighbourhood_members_cuda,
                   stencil.neighbourhood_members_plain, K1_BAR)}[kind]
        if kind == "K5" and row.stat in stencil.MINMAX_STATS:
            bar = None
        if row.uniform:
            x = rng.random(row.shape, dtype=np.float32)
        else:
            # the benchmark background (its anomaly for K3)
            x = rng.normal(280, 5, row.shape).astype(np.float32)
            if kind == "K3":
                x -= np.float32(280.0)
        x = tensor(x)
        stat = row.stat
        if row.plain or not cuda:
            return Made(row, lambda a: plain(a, h, h, stat), (x,))
        k = 2 * h + 1
        library, lib_bar = None, (K1_BAR if h <= 7 else WIDE_LIBRARY_BAR)
        if kind == "K1":
            def library(a):
                return F.avg_pool2d(a[None, None], k, 1, h,
                                    count_include_pad=False)[0, 0]
        elif kind == "K2":
            def library(a):
                return F.max_pool2d(a[None, None], k, 1, h)[0, 0]
            lib_bar = None
        elif kind == "K5":
            # (Y, X, E) is the channels-last memory of (1, E, Y, X)
            def library(a):
                return F.avg_pool2d(a.permute(2, 0, 1)[None], k, 1, h,
                                    count_include_pad=False)[0].permute(
                    1, 2, 0)
        return Made(row, lambda a: wrapper(a, h, h, stat), (x,),
                    lambda a: plain(a, h, h, stat), bar, device, library,
                    lib_bar, wrapper)
    if kind == "K4":
        x = tensor(rng.random(row.shape, dtype=np.float32))
        thr = torch.linspace(0, 1, row.t, device=device)
        q = 0.5

        def plain(a, th):
            return nops._quantile_fast_xla(a, q, h, th)
        if row.plain or not cuda:
            return Made(row, plain, (x, thr))
        wrapper = stencil.neighbourhood_quantile_fast_cuda
        return Made(row, lambda a, th: wrapper(a, q, h, h, th), (x, thr),
                    plain, None, device, wrapper=wrapper)
    if kind == "ensi":
        from ..ops.oi_ensi import ensi_update_cuda, ensi_update_plain
        b, s, e, p = row.shape
        tab = np.concatenate([rng.normal(280, 5, (p, 1)),
                              np.full((p, 1), 1.5),
                              rng.normal(280, 5, (p, 1)),
                              rng.normal(0, 5, (p, e))], axis=1)
        args = (tensor(rng.normal(280, 5, (b, e)).astype(np.float32)),
                torch.ones((b, s), dtype=torch.bool, device=device),
                tensor(rng.uniform(0.1, 1, (b, s)).astype(np.float32)),
                tensor(rng.integers(0, p, (b, s))),
                tensor(tab.astype(np.float32)))

        def plain(bg, valid, rho, g, tab):
            return ensi_update_plain(g, rho, valid, tab, bg, True)[0]
        if row.plain or not cuda:
            # the chain on the card held to the CPU's, where that is quick
            check = cuda and b <= PLAIN_CHECK_ROWS
            return Made(row, plain, args, plain if check else None,
                        ENSI_BAR, torch.device("cpu") if check else None)

        def kernel(bg, valid, rho, g, tab):
            return ensi_update_cuda(g, rho, valid, tab, bg, True)[0]
        # held to the plain chain on the card: the CPU's would take
        # seconds at the cell's block
        return Made(row, kernel, args, plain, ENSI_BAR, device,
                    wrapper=ensi_update_cuda)
    if kind == "oi":
        from ..api.oi import _origin, _resolved_fields
        from ..ops.oi import oi_block_dense
        b, p, s = row.shape
        structure = gt.BarnesStructure(10000.0)
        pts = gt.Points(rng.uniform(55, 62, p), rng.uniform(5, 12, p),
                        np.zeros(p), np.zeros(p))
        gpts = gt.Points(rng.uniform(55, 62, b), rng.uniform(5, 12, b),
                         np.zeros(b), np.zeros(b))
        origin = _origin(gpts)
        p1 = {k: tensor(np.asarray(v, np.float32).reshape(b, 1))
              for k, v in _resolved_fields(gpts, structure, origin).items()}
        of = {k: tensor(np.asarray(v, np.float32))
              for k, v in _resolved_fields(pts, structure, origin).items()}
        bg = tensor(rng.normal(280, 5, b).astype(np.float32))
        pobs = tensor(rng.normal(280, 5, p).astype(np.float32))
        args = (bg, torch.ones_like(bg), p1, of, pobs, pobs.clone(),
                torch.full((p,), 0.1, device=device))

        def fn(background, bvariance, p1d, ofd, obs, obs_y, ratios):
            return oi_block_dense(structure, p1d, ofd, background, bvariance,
                                  obs, obs_y, ratios, s, True)[0]
        return Made(row, fn, args, fn if cuda else None, OI_BAR,
                    torch.device("cpu") if cuda else None)
    if kind == "tiled":
        ny, nx, p, s = row.shape[:4]
        lats, lons = np.meshgrid(np.linspace(55, 60, ny),
                                 np.linspace(5, 10, nx), indexing="ij")
        pts = gt.Points(rng.uniform(55, 60, p), rng.uniform(5, 10, p),
                        np.zeros(p), np.zeros(p))
        pipe = gt.Pipeline(gt.Grid(lats, lons), pts,
                           gt.BarnesStructure(20000.0), halfwidth=0,
                           max_points=s, tiled=True, device=device)
        geom, gd = pipe._geom, pipe._geom_dev
        t, tb, k = gd["local_idx"].shape
        c, f = gd["tile_static"].shape[1:]
        row = row._replace(shape=(ny, nx, p, s, k, t, tb, c, f))
        fn = tiled_fn(pipe.structure, geom, pipe._static_keys, s)
        args = (tensor(rng.normal(280, 5, (ny, nx)).astype(np.float32)),
                tensor(rng.normal(280, 5, p).astype(np.float32)),
                tensor(np.full(p, 0.1, np.float32)),
                {key: gd[key] for key in ("tile_table", "local_idx", "rho",
                                          "valid", "tile_static")},
                pipe._obs_nn)
        return Made(row, fn, args, fn if cuda else None, OI_BAR,
                    torch.device("cpu") if cuda else None)
    raise ValueError(f"no row kind {kind!r}")


def _compare(got, want, bar):
    """(ok, max abs difference): NaN in the same places, equal (bar None)
    or within (rtol, atol)."""
    want = want.to(got.device)
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    err = float(torch.nan_to_num(got - want).abs().max()) if got.numel() \
        else 0.0
    if bar is None:
        ok = bool(torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))
    else:
        ok = bool(torch.allclose(got, want, rtol=bar[0], atol=bar[1],
                                 equal_nan=True))
    return same_nan and ok, err


def characterize(made: Made, rates=None, bw=None, trace=None) -> dict:
    """Check and time one made row (see the module's docstring); rates
    (a PEAKS dict) and bw (measured bytes/s) give the shares. Raises when
    the row disagrees with its plain version or its kernel did not launch
    once a call."""
    row = made.row
    device = next(a.device for a in _tensors(made.args))
    cuda = device.type == "cuda"
    nbytes, ops, peak = count(row)
    out = {"kernel": row.label, "kind": row.kind, "device": device.type,
           "shape": list(row.shape), "bytes": nbytes, "ops": ops,
           "ops_peak": peak, "ops_per_byte": ops / nbytes,
           "sources": sorted(sources(row)) if cuda else [],
           "max_abs_err": None}
    if made.plain is not None:
        check_args = _map(lambda t: t.to(made.check_device), made.args)
        ok, err = _compare(made.fn(*made.args), made.plain(*check_args),
                           made.bar)
        if not ok:
            raise AssertionError(f"{row.label}: max|d|={err:.3g} against "
                                 f"its plain version (bar {made.bar})")
        out["max_abs_err"] = err
        del check_args
    iters = _iters(made.fn, made.args, device)
    w = made.wrapper
    before = w.launches if w is not None else 0
    warm = warm_ms(made.fn, made.args, iters, device)
    if w is not None and w.launches - before != iters:
        raise AssertionError(f"{row.label}: {w.launches - before} launches "
                             f"of {w.__name__} in {iters} calls")
    cold = cold_ms(made.fn, made.args, iters, device)
    times = {"warm_ms": warm, "cold_ms": cold, "iters": iters}
    if not cuda:
        out.update({f"cpu_{k}" if k.endswith("_ms") else k: v
                    for k, v in times.items()})
        out.update(dict.fromkeys(DEVICE_KEYS, NOT_MEASURED))
        out["bound_by"] = NOT_MEASURED
        return out
    out.update(times)
    out["device_ms"] = device_ms(made.fn, made.args,
                                 min(iters, PROFILE_ITERS), 0.5 * warm,
                                 trace)
    out["library_ms"] = None
    if made.library is not None:
        ok, err = _compare(made.fn(*made.args), made.library(*made.args),
                           made.library_bar)
        if not ok:
            raise AssertionError(f"{row.label}: the library call is not "
                                 f"the same function (max|d|={err:.3g})")
        out["library_ms"] = cold_ms(made.library, made.args, device=device)
    out["gops_s"] = ops / (cold / 1e3) / 1e9
    out["gbytes_s"] = nbytes / (cold / 1e3) / 1e9
    if rates is None:
        out.update(bound_ms=NOT_MEASURED, bound_by=NOT_MEASURED,
                   pct_peak=NOT_MEASURED)
    else:
        out["bound_ms"], out["bound_by"] = bound((nbytes, ops, peak), rates)
        out["pct_peak"] = 100.0 * out["bound_ms"] / cold
    out["pct_measured_bw"] = (NOT_MEASURED if bw is None else
                              100.0 * nbytes / (cold / 1e3) / bw)
    return out


def run(scale: float = 1.0, device="cuda", trace=None, log=print,
        seed=0) -> list:
    """Every row at `scale` on `device`, in order; returns the row dicts.
    On the card the rows must launch every kernel of ops.stencil.KERNELS
    (else it raises before timing anything)."""
    from ..ops import stencil
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("roofline: no CUDA card (pass --device cpu for "
                           "the plain versions on the CPU)")
    specs = rows(scale)
    rates = bw = None
    if cuda:
        covered = set().union(*(sources(r) for r in specs))
        missing = set(stencil.KERNELS) - covered
        if missing:
            raise RuntimeError(f"roofline: no row launches {sorted(missing)}")
        # one nvcc a source, all started together
        with ThreadPoolExecutor(len(stencil.KERNELS)) as pool:
            list(pool.map(stencil.build_kernel, stencil.KERNELS))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        found = peaks(device)
        rates = found and found[1]
        bw = measured_bw(device)
        log(f"card: {smi}", flush=True)
        log("peaks: " + (NOT_MEASURED if found is None else
                         f"{rates['bytes'] / 1e12:.2f} TB/s, "
                         f"{rates['f32'] / 1e12:.1f} TFLOP/s f32, "
                         f"{rates['int32'] / 1e12:.2f} TOP/s int32 "
                         f"({found[2]})"), flush=True)
        log(f"measured bandwidth: {bw / 1e9:.1f} GB/s (torch.add on 8192^2 "
            "f32)", flush=True)
    else:
        log("device: cpu (plain versions; every device column not "
            "measured)", flush=True)
    if trace:
        os.makedirs(trace, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i, spec in enumerate(specs):
        t0 = time.perf_counter()
        made = make(spec, device, rng)
        path = (os.path.join(trace, f"row{i:02d}.json")
                if trace and cuda else None)
        res = characterize(made, rates, bw, path)
        del made
        if cuda:
            torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        out.append(res)
        cold = res["cold_ms"] if cuda else res["cpu_cold_ms"]
        log(f"{res['kernel']}: {cold:.4f} ms cold on the {device.type} "
            f"({res['wall_s']:.1f} s)", flush=True)
    return out


def _fmt(v, spec=".4f"):
    if v is None:
        return "-"
    if isinstance(v, str):
        return v
    return format(v, spec)


def table(results, log=print):
    """The rows as a markdown table."""
    cuda = any(r["device"] == "cuda" for r in results)
    if cuda:
        log("| kernel | warm ms | cold ms | device ms | bound ms (by) | "
            "GOP/s | GB/s (io) | ops/byte | % bound | % measured BW | "
            "library ms |")
        log("|---|---|---|---|---|---|---|---|---|---|---|")
        for r in results:
            log(f"| {r['kernel']} | {_fmt(r['warm_ms'])} | "
                f"{_fmt(r['cold_ms'])} | {_fmt(r['device_ms'])} | "
                f"{_fmt(r['bound_ms'])} ({r['bound_by']}) | "
                f"{_fmt(r['gops_s'], '.1f')} | {_fmt(r['gbytes_s'], '.1f')} | "
                f"{r['ops_per_byte']:.2f} | {_fmt(r['pct_peak'], '.1f')} | "
                f"{_fmt(r['pct_measured_bw'], '.1f')} | "
                f"{_fmt(r['library_ms'])} |")
    else:
        log("| kernel | bytes | ops | ops/byte | CPU warm ms | CPU cold ms "
            "| device columns |")
        log("|---|---|---|---|---|---|---|")
        for r in results:
            log(f"| {r['kernel']} | {r['bytes']} | {r['ops']:.0f} | "
                f"{r['ops_per_byte']:.2f} | {r['cpu_warm_ms']:.4f} | "
                f"{r['cpu_cold_ms']:.4f} | {NOT_MEASURED} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler chrome trace of each row's "
                         "warm loop to DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels on the card) or cpu "
                         "(the plain versions; no device columns)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale every side, batch and obs count")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("roofline: no CUDA card (pass --device cpu for the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # the EnSI update's plain chain runs its products in full f32
        # (ops.oi_ensi._mm)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results = run(args.scale, device, args.trace)
    with contextlib.suppress(BrokenPipeError):
        table(results)
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
