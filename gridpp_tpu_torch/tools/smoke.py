"""All-API smoke gate of gridpp_tpu_torch on a card machine.

Calls every public name of gridpp_tpu_torch once (and the statistic axis
of the neighbourhood functions, 2-D and 3-D) with torch's default device
untouched, by two routes:

(a) the top level, which gridpp_tpu_torch pins to the host: each call must
    leave the card untouched, i.e. the caching allocator's count of
    allocations on the card does not rise across the call;
(b) the module function `gridpp_tpu_torch.api.<module>.<name>` of every
    name whose code reads `api_device()` / `on_host()` (its device route),
    called unpinned with the same arguments: each call must allocate on
    the card.

Then the device entry points, with the device named explicitly: Pipeline
(Mean h=3, tiled: the fast and general paths), EnsiPipeline, the three
MultiEnsiPipeline variants, ops.neighbourhood for all eight statistics,
ops.neighbourhood_quantile_fast and ops.stencil.neighbourhood_members on
a (Y, X, 4) field. On the card these must launch each of K1-K5.

A CPU test suite cannot see a module function that stays on the host
while a card is present; this gate can.

    python -m gridpp_tpu_torch.tools.smoke                # on the card
    python -m gridpp_tpu_torch.tools.smoke --device cpu   # (a) and the
                                                          # entry points

Prints the counts of calls, passes, failures and uncovered names, then
SMOKE PASS or SMOKE FAIL. Exits 1 on any failure or uncovered name, 2 when
the card it was asked for is absent.
"""
from __future__ import annotations

import argparse
import dis
import importlib
import pkgutil
import sys
import time
import traceback
import types
from typing import NamedTuple

import numpy as np
import torch

# Public names with no meaningful standalone smoke: the enum families are
# IntEnums that nearly every registered call takes as an argument.
WAIVED = {
    "Statistic", "Metric", "Extrapolation", "CorrectionType",
    "CoordinateType", "GradientType", "Downscaler", "ComparisonOperator",
}
KERNELS = ("K1", "K2", "K3", "K4", "K5")


class Call(NamedTuple):
    """One call of a public function: `fn(*args)`, by route (a) and, where
    the function has a device route, by route (b)."""
    args: tuple


def C(*args) -> Call:
    return Call(args)


def problem(g):
    """The smoke's data: a 16 x 20 grid, 12 points and fields, seed 0."""
    rng = np.random.default_rng(0)
    d = types.SimpleNamespace(ny=16, nx=20, npts=12)
    ny, nx, npts = d.ny, d.nx, d.npts
    lats, lons = np.meshgrid(np.linspace(55, 58, ny),
                             np.linspace(5, 8, nx), indexing="ij")
    d.elevs = rng.uniform(0, 500, (ny, nx)).astype(np.float32)
    d.lafs = rng.uniform(0, 1, (ny, nx)).astype(np.float32)
    d.grid = g.Grid(lats, lons, d.elevs, d.lafs)
    olats, olons = np.meshgrid(np.linspace(55.1, 57.9, 2 * ny),
                               np.linspace(5.1, 7.9, 2 * nx), indexing="ij")
    d.ogrid = g.Grid(olats, olons)
    d.plats = rng.uniform(55.2, 57.8, npts)
    d.plons = rng.uniform(5.2, 7.8, npts)
    d.points = g.Points(d.plats, d.plons, rng.uniform(0, 400, npts),
                        rng.uniform(0, 1, npts))
    d.field = rng.normal(280, 5, (ny, nx)).astype(np.float32)
    d.field3 = rng.normal(280, 5, (ny, nx, 3)).astype(np.float32)
    d.pobs = rng.normal(280, 5, npts).astype(np.float32)
    d.ratios = np.full(npts, 0.1, np.float32)
    d.structure = g.BarnesStructure(50000.0, 100.0, 0.5)
    d.curve_x = np.linspace(270, 290, 9).astype(np.float32)
    d.curve_y = (d.curve_x + 1.5).astype(np.float32)
    d.thresholds = np.linspace(270, 290, 7).astype(np.float32)
    d.vec = rng.normal(0, 1, 20).astype(np.float32)
    d.ref_b = (rng.random(40) > 0.5).astype(np.float32) * 2
    d.fcst_b = d.ref_b + rng.normal(0, 0.5, 40).astype(np.float32)
    d.pback = g.nearest(d.grid, d.points, d.field)
    d.bg_ens = rng.normal(280, 5, (ny, nx, 4)).astype(np.float32)
    d.pbg_ens = np.stack([g.nearest(d.grid, d.points, d.bg_ens[:, :, e])
                          for e in range(4)], axis=1)
    d.bratios = np.full((ny, nx), 0.1, np.float32)
    # perturbed obs (S, E) of ebe/ebesc
    d.pobs_e = (d.pobs[:, None] + rng.normal(0, 0.5, (npts, 4))).astype(
        np.float32)
    d.stats = [g.Mean, g.Min, g.Median, g.Max, g.Std, g.Variance, g.Sum,
               g.Count]
    return d


def _expect_raises(fn, exc):
    try:
        fn()
    except exc:
        return True
    raise AssertionError(f"expected {exc.__name__}")


def registry(g, d):
    """Public name -> its cases: a `Call` of `g.<name>`, or a thunk for the
    classes and the calls that are not one call of the name."""
    ny, nx, npts = d.ny, d.nx, d.npts
    grid, ogrid, points, field, field3 = (d.grid, d.ogrid, d.points,
                                          d.field, d.field3)
    pobs, ratios, structure, vec = d.pobs, d.ratios, d.structure, d.vec
    curve_x, curve_y = d.curve_x, d.curve_y
    bg_ens, pbg_ens, bratios, pobs_e = (d.bg_ens, d.pbg_ens, d.bratios,
                                        d.pobs_e)
    thr280 = np.full((2 * ny, 2 * nx), 280, np.float32)
    lapse = np.full((ny, nx), -0.0065, np.float32)

    def _pt(lat, lon):
        return g.Point(lat, lon, 0.0, 0.0)

    R = {}

    def reg(name, *cases):
        R[name] = list(cases)

    # --- core classes ---------------------------------------------------
    reg("Grid", lambda: grid.get_nearest_neighbour(56.0, 6.0),
        lambda: grid.to_points().size())
    reg("Points", lambda: points.get_closest_neighbours(56.0, 6.0, 3),
        lambda: points.subset([0, 1, 2]).size())
    reg("Point", lambda: _pt(56.0, 6.0).lat)
    reg("KDTree", lambda: g.KDTree(d.plats, d.plons).size())
    reg("BarnesStructure", lambda: structure.corr(_pt(56, 6), _pt(56, 6.1)))
    for cls in ("CressmanStructure", "SoarStructure", "ToarStructure",
                "PowerlawStructure"):
        reg(cls, (lambda c: lambda: getattr(g, c)(5e4).corr(
            _pt(56, 6), _pt(56, 6.1)))(cls))
    reg("LinearStructure",
        lambda: g.LinearStructure(1.0).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("MultipleStructure",
        lambda: g.MultipleStructure(
            g.BarnesStructure(5e4), g.BarnesStructure(5e4),
            g.BarnesStructure(5e4)).corr(_pt(56, 6), _pt(56, 6.1)))
    reg("CrossValidation",
        lambda: g.CrossValidation(structure, 1000.0).corr_background(
            _pt(56, 6), _pt(56, 6.1)))
    reg("StructureFunction", lambda: structure.localization_distance)
    reg("Transform", lambda: g.Identity().forward(1.0))
    reg("Identity", lambda: g.Identity().backward(np.float32(2.0)))
    reg("Log", lambda: g.Log().backward(g.Log().forward(2.0)))
    reg("BoxCox", lambda: g.BoxCox(0.5).forward(field))
    reg("StartedBoxCox", lambda: g.StartedBoxCox(0.5, 1.0).forward(field))
    reg("Gamma", lambda: g.Gamma(2.0, 1.5).forward(np.float32(1.0)))

    # --- downscaling ----------------------------------------------------
    field_t3 = np.stack([field, field + 1, field + 2])  # vec3 = (T, Y, X)
    reg("nearest", C(grid, ogrid, field), C(grid, points, field_t3))
    reg("bilinear", C(grid, ogrid, field))
    reg("downscaling", C(grid, ogrid, field, g.Nearest),
        C(grid, points, field, g.Bilinear))
    reg("simple_gradient", C(grid, ogrid, field, -0.0065))
    reg("full_gradient", C(grid, ogrid, field, lapse))
    reg("full_gradient_debug", C(grid, ogrid, field, lapse))
    reg("calc_gradient", C(d.elevs, field, g.LinearRegression, 3),
        C(d.elevs, field, g.MinMax, 3))
    reg("downscale_probability", C(grid, ogrid, field3, thr280, g.Gt))
    reg("mask_threshold_downscale_consensus",
        C(grid, ogrid, field3, field3 + 1, field3, thr280, g.Gt, g.Mean))
    reg("mask_threshold_downscale_quantile",
        C(grid, ogrid, field3, field3 + 1, field3, thr280, g.Gt, 0.5))

    # --- neighbourhood (every statistic, 2-D and 3-D) --------------------
    reg("neighbourhood", *[C(field, 3, s) for s in d.stats],
        *[C(field3, 3, s) for s in d.stats], C(field, 0, g.Mean))
    reg("neighbourhood_brute_force", C(field, 2, g.Mean),
        C(field3, 2, g.Max))
    reg("neighbourhood_ens", C(field3, 2, g.Mean))
    reg("neighbourhood_quantile", C(field, 0.5, 2), C(field3, 0.9, 2))
    reg("neighbourhood_quantile_ens", C(field3, 0.5, 2))
    reg("neighbourhood_quantile_fast", C(field, 0.5, 3, d.thresholds),
        C(field3, 0.5, 3, d.thresholds),
        C(field, np.full((ny, nx), 0.5, np.float32), 3, d.thresholds))
    reg("neighbourhood_quantile_ens_fast", C(field3, 0.5, 2, d.thresholds))
    reg("get_neighbourhood_thresholds", C(field, 11))
    reg("neighbourhood_search", C(field, field, 2, 279, 281, 0.1))
    reg("window", C(field, 5, g.Mean, False, False, True),
        C(field, 4, g.Max, True, True, False))
    reg("neighbourhood_score",
        *[C(grid, points, field, pobs, 3, m, 280.0)
          for m in (g.Ets, g.Ts, g.Kss, g.Pc, g.Bias, g.Hss)])

    # --- calibration ----------------------------------------------------
    reg("apply_curve", C(field, curve_y, curve_x, g.OneToOne, g.MeanSlope))
    reg("monotonize_curve", C(curve_y, curve_x))
    reg("quantile_mapping_curve", C(vec, vec + 1))
    reg("metric_optimizer_curve",
        C(d.ref_b, d.fcst_b, np.array([0.5, 1.5], np.float32), g.Ets))
    reg("get_optimal_threshold", C(d.ref_b, d.fcst_b, 1.0, g.Ets))
    reg("calc_score", C(10.0, 3.0, 2.0, 25.0, g.Ets),
        C(d.ref_b, d.fcst_b, 1.0, g.Pc))

    # --- OI family ------------------------------------------------------
    reg("optimal_interpolation",
        C(grid, field, points, pobs, ratios, d.pback, structure, 5))
    reg("optimal_interpolation_full",
        C(grid, field, np.ones((ny, nx), np.float32), points, pobs,
          np.full(npts, 0.1, np.float32), d.pback,
          np.ones(npts, np.float32), structure, 5))
    reg("optimal_interpolation_ensi",
        C(grid, bg_ens, points, pobs, np.full(npts, 1.5, np.float32),
          pbg_ens, structure, 5))
    reg("optimal_interpolation_ensi_multi_ebe",
        C(grid, bratios, bg_ens, bg_ens, points, pobs_e, ratios, pbg_ens,
          pbg_ens, structure, 5))
    reg("optimal_interpolation_ensi_multi_ebesc",
        C(grid, bratios, bg_ens, points, pobs_e, ratios, pbg_ens,
          structure, 5))
    reg("optimal_interpolation_ensi_multi_utem",  # pobs as a vec (S,)
        C(grid, bratios, bg_ens, bg_ens, points, pobs, ratios, pbg_ens,
          pbg_ens, structure, 5))
    reg("local_distribution_correction",
        C(grid, np.abs(field - 275), points, np.abs(pobs - 275),
          np.abs(d.pback - 275), structure, 0.1, 0.9))
    reg("staticcorr_points", C(points, points, structure, 5))
    reg("smart", C(grid, ogrid, field, 3, structure))

    # --- gridding / fill ------------------------------------------------
    reg("gridding", C(grid, points, pobs, 20000.0, 1, g.Mean))
    reg("gridding_nearest", C(grid, points, pobs, 1, g.Mean))
    reg("count", C(points, grid, 20000.0), C(grid, points, 20000.0))
    reg("distance", C(grid, points, 1), C(points, grid, 2))
    reg("fill", C(grid, field, points, np.full(npts, 1e4, np.float32),
                  260.0, False))
    reg("fill_missing", C(np.where(field > 282, np.nan, field)))
    reg("doping_square",
        C(grid, field, points, pobs, np.ones(npts, np.int32)))
    reg("doping_circle",
        C(grid, field, points, pobs, np.full(npts, 1e4, np.float32)))

    # --- diagnostics ----------------------------------------------------
    reg("dewpoint", C(283.0, 0.8), C(field, np.full_like(field, 0.8)))
    reg("relative_humidity", C(283.0, 280.0))
    reg("wetbulb", C(283.0, 101325.0, 0.8))
    reg("pressure", C(100.0, 50.0, 101325.0, 288.0))
    reg("sea_level_pressure", C(101325.0, 100.0, 288.0, 0.8))
    reg("qnh", C(101325.0, 100.0),
        C(np.full(3, 101325.0, np.float32), np.full(3, 100.0, np.float32)))
    reg("wind_speed", C(3.0, 4.0), C(field, field))
    reg("wind_direction", C(3.0, 4.0))
    reg("gamma_inv", C(0.5, 2.0, 1.5))

    # --- util -----------------------------------------------------------
    reg("calc_statistic", *[C(vec, s) for s in d.stats])
    reg("calc_quantile", C(vec, 0.5), C(field, 0.9))
    reg("calc_even_quantiles", C(vec, 5))
    reg("interpolate", C(0.5, curve_x, curve_y))
    reg("get_lower_index", C(275.0, curve_x))
    reg("get_upper_index", C(275.0, curve_x))
    reg("compatible_size", C(field, field3))
    reg("convert_coordinates", C(d.plats, d.plons))
    reg("is_valid", lambda: g.is_valid(1.0) and not g.is_valid(np.nan))
    reg("is_valid_lat", C(56.0))
    reg("is_valid_lon", C(5.0))
    reg("num_missing_values", C(np.where(field > 282, np.nan, field)))
    reg("point_in_rectangle",
        C(_pt(0, 0), _pt(0, 1), _pt(1, 1), _pt(1, 0), _pt(0.5, 0.5)))
    reg("init_vec2", C(2, 3))
    reg("init_vec3", C(2, 3, 4, 1.0))
    reg("init_ivec2", C(2, 3, 0))
    reg("init_ivec3", C(2, 3, 4, 0))
    reg("get_statistic", C("mean"))
    for name in ("version", "clock", "get_omp_threads", "initialize_omp",
                 "get_debug_level"):
        reg(name, C())
    reg("set_omp_threads", C(4))
    reg("set_debug_level", C(0))
    reg("KDTree_calc_distance", C(56.0, 6.0, 56.1, 6.1))
    reg("KDTree_calc_distance_fast", C(56.0, 6.0, 56.1, 6.1))
    reg("KDTree_calc_straight_distance", C(_pt(56.0, 6.0), _pt(56.1, 6.1)),
        C(0.0, 0.0, 0.0, 1.0, 2.0, 2.0))
    reg("KDTree_deg2rad", C(180.0))
    reg("KDTree_rad2deg", C(np.pi))

    # --- binding-parity shims -------------------------------------------
    reg("test_vec_input", C(vec))
    reg("test_ivec_input", C([1, 2, 3]))
    reg("test_vec2_input", C(field))
    reg("test_vec3_input", C(field3))
    for name in ("test_vec_output", "test_vec2_output", "test_vec3_output",
                 "test_ivec_output", "test_ivec2_output",
                 "test_ivec3_output", "test_vec_argout",
                 "test_vec2_argout"):
        reg(name, C())
    reg("test_array", C(vec))
    reg("test_not_implemented_exception",
        lambda: _expect_raises(g.test_not_implemented_exception,
                               NotImplementedError))
    reg("error", lambda: _expect_raises(lambda: g.error("smoke"),
                                        RuntimeError))
    reg("debug", C("smoke"))
    reg("warning", C("smoke"))
    reg("future_deprecation_warning", C("smoke"))
    return R


def entry_points(g, d, dev):
    """The device entry points on dev, by name: thunks that check their
    outputs are finite and on dev."""
    from ..ops import neighbourhood as nops
    from ..ops import stencil

    def t(a):
        return torch.as_tensor(a, device=dev)

    def finite(*outs):
        for out in outs:
            if out.device != dev or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"output on {out.device}, finite: "
                                     f"{bool(torch.isfinite(out).all())}")
        return True

    def pipeline():
        pipe = g.Pipeline(d.grid, d.points, d.structure, halfwidth=3,
                          statistic=g.Mean, max_points=5, ratios=d.ratios,
                          tiled=True, device=dev)
        return finite(*(pipe.run_device(t(d.field), t(d.pobs), path=path)
                        for path in ("fast", "general")))

    def ensi_pipeline():
        ep = g.EnsiPipeline(d.grid, d.points, d.structure, max_points=5,
                            device=dev)
        out, _ = ep.run_device(t(d.bg_ens), t(d.pobs),
                               t(np.full(d.npts, 1.5, np.float32)))
        return finite(out)

    def multi_pipeline(variant):
        def run():
            mp = g.MultiEnsiPipeline(d.grid, d.points, d.structure,
                                     variant=variant, max_points=5,
                                     device=dev)
            ob = d.pobs if variant == "utem" else d.pobs_e
            bc = None if variant == "ebesc" else t(d.bg_ens)
            out, _ = mp.run_device(t(d.bg_ens), t(ob), t(d.ratios),
                                   background_corr=bc)
            return finite(out)
        return run

    def ops_neighbourhood(stat):
        return lambda: finite(nops.neighbourhood(t(d.field), 3, int(stat)))

    return {
        "Pipeline": [pipeline],
        "EnsiPipeline": [ensi_pipeline],
        "MultiEnsiPipeline": [multi_pipeline(v)
                              for v in ("ebesc", "utem", "ebe")],
        "ops.neighbourhood": [ops_neighbourhood(s) for s in d.stats],
        "ops.neighbourhood_quantile_fast": [
            lambda: finite(nops.neighbourhood_quantile_fast(
                t(d.field), 0.5, 3, t(d.thresholds)))],
        "ops.stencil.neighbourhood_members": [
            (lambda s: lambda: finite(stencil.neighbourhood_members(
                t(d.bg_ens), 3, int(s))))(s) for s in (g.Mean, g.Max)],
    }


def _globals_read(code) -> set:
    names = {ins.argval for ins in dis.get_instructions(code)
             if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _globals_read(const)
    return names


def _reads_device(fn, module, seen) -> bool:
    names = _globals_read(fn.__code__)
    if names & {"api_device", "on_host"}:
        return True
    for name in names - seen:
        other = vars(module).get(name)
        if (isinstance(other, types.FunctionType)
                and other.__module__ == module.__name__):
            seen.add(name)
            if _reads_device(other, module, seen):
                return True
    return False


def device_routes() -> dict:
    """"<module>.<name>" -> function, for every public function of
    gridpp_tpu_torch.api.<module> whose code reads `api_device()` or
    `on_host()`, itself or through a function of its module."""
    from .. import api
    routes = {}
    for info in pkgutil.iter_modules(api.__path__):
        if info.name.startswith("_"):
            continue
        module = importlib.import_module(f"{api.__name__}.{info.name}")
        for name, fn in vars(module).items():
            if (isinstance(fn, types.FunctionType) and not name.startswith("_")
                    and fn.__module__ == module.__name__
                    and _reads_device(fn, module, {name})):
                routes[f"{info.name}.{name}"] = fn
    return routes


def public_names(g) -> set:
    """The package's public functions and classes (tools/tpu_smoke.py's
    rule)."""
    return {name for name, obj in vars(g).items()
            if not name.startswith("_")
            and isinstance(obj, (types.FunctionType, type))}


def device_cases(R) -> dict:
    """"<module>.<name>" -> the `Call` cases of R[name] that take the
    module function's device route (the neighbourhood functions' card
    route takes the stencil statistics only)."""
    from ..api.neighbourhood import _DEVICE_STATS
    cases = {}
    for key in device_routes():
        name = key.split(".", 1)[1]
        calls = [c for c in R.get(name, ()) if isinstance(c, Call)]
        if name in ("neighbourhood", "neighbourhood_ens"):
            calls = [c for c in calls if int(c.args[2]) in _DEVICE_STATS]
        cases[key] = calls
    return cases


def _allocations(dev) -> int:
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)


def _launch_counts() -> dict:
    from ..ops import stencil
    wrappers = (stencil.neighbourhood_mean_cuda,
                stencil.neighbourhood_minmax_cuda,
                stencil.neighbourhood_var_cuda,
                stencil.neighbourhood_quantile_fast_cuda,
                stencil.neighbourhood_members_cuda)
    return dict(zip(KERNELS, (w.launches for w in wrappers)))


def run(device="cuda") -> dict:
    """Run the gate on device ("cuda": both routes and the entry points on
    the card; "cpu": route (a) and the entry points on the CPU). Returns
    the counts, the failures [(name, case, route, traceback)], the
    uncovered names and the entry points' kernel launches."""
    import gridpp_tpu_torch as g

    dev = torch.device(device)
    card = dev.type == "cuda"
    if card:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.init()
    t0 = time.perf_counter()
    d = problem(g)
    R = registry(g, d)
    entries = entry_points(g, d, dev)
    routes = device_routes()
    dcases = device_cases(R)
    uncovered = sorted(public_names(g) - set(R) - set(entries) - WAIVED)
    uncovered += sorted(k for k, c in dcases.items() if not c)
    failures = []
    counts = {"host": 0, "device": 0, "entry": 0}

    def attempt(route, name, k, thunk, moves):
        """thunk() by route; moves: whether it must allocate on the card
        (True), must not (False), or either (None: the CPU)."""
        before = _allocations(dev)
        try:
            thunk()
            if card:
                torch.cuda.synchronize(dev)
            grew = _allocations(dev) > before
            if moves is not None and grew != moves:
                raise AssertionError(
                    "allocated on the card" if grew
                    else "made no allocation on the card")
        except Exception:
            failures.append((name, k, route, traceback.format_exc(limit=8)))
        counts[route] += 1

    def call(fn, case):
        return case if not isinstance(case, Call) else (
            lambda: fn(*case.args))

    # (a) the top level: pinned to the host
    for name in sorted(R):
        for k, case in enumerate(R[name]):
            attempt("host", name, k, call(getattr(g, name), case),
                    False if card else None)
    # (b) each module function with a device route, unpinned
    if card:
        for key in sorted(dcases):
            for k, case in enumerate(dcases[key]):
                attempt("device", key, k, call(routes[key], case), True)
    before = _launch_counts()
    for name, thunks in entries.items():
        for k, thunk in enumerate(thunks):
            attempt("entry", name, k, thunk, True if card else None)
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    if card:
        for k, n in launches.items():
            if n == 0:
                failures.append((f"entry points: {k}", 0, "entry",
                                 f"{k} never launched\n"))
    return {"device": str(dev), "calls": sum(counts.values()),
            "passed": sum(counts.values()) - len(failures),
            "counts": counts, "failures": failures, "uncovered": uncovered,
            "functions": len(R) + len(entries),
            "device_routes": sorted(dcases), "launches": launches,
            "seconds": time.perf_counter() - t0}


def report(res, log=print) -> bool:
    """Print run()'s result; True when the gate passed."""
    c = res["counts"]
    log(f"device={res['device']}  calls={res['calls']}  "
        f"pass={res['passed']}  fail={len(res['failures'])}  "
        f"uncovered={len(res['uncovered'])}  functions={res['functions']}  "
        f"elapsed={res['seconds']:.1f}s")
    log(f"  (a) top level, pinned to the host: {c['host']} calls")
    log(f"  (b) module functions' device route: {c['device']} calls of "
        f"{len(res['device_routes'])} functions")
    log(f"  entry points: {c['entry']} calls; kernel launches "
        + ", ".join(f"{k}={n}" for k, n in res["launches"].items()))
    if res["uncovered"]:
        log(f"UNCOVERED ({len(res['uncovered'])}): "
            f"{', '.join(res['uncovered'])}")
    for name, k, route, tb in res["failures"]:
        log(f"\n--- FAIL {name}[{k}] ({route}) ---\n{tb}")
    ok = not res["failures"] and not res["uncovered"]
    log("SMOKE " + ("PASS" if ok else "FAIL"))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: both routes on the card) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("smoke: no CUDA card (pass --device cpu for the CPU run)",
              file=sys.stderr)
        return 2
    return 0 if report(run(args.device)) else 1


if __name__ == "__main__":
    sys.exit(main())
