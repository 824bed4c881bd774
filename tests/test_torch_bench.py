"""gridpp_tpu_torch.tools.bench, the port's bench.py, and the pipelines'
serve_stream on the CPU.

- The tool at a small size prints one JSON line holding every key of
  bench.py's line, read from bench.py's source by `ast` (the literal keys
  of `out`, the keys passed to bench_path and stream_rates and the
  f-string suffixes bench.py adds to them), plus the tool's four
  additions; every number finite.
- Its problem is bench.py's draws in bench.py's order, with pback from
  gridpp_tpu.nearest, bit for bit.
- It exits 1 and prints no line when general and general_resolve part by
  one ulp.
- serve_stream of Pipeline, EnsiPipeline and MultiEnsiPipeline (utem, and
  ebe with background_corr) yields, in order and bit for bit, what a loop
  of __call__ gives on the same cycles, and agrees with gridpp_tpu's
  serve_stream: Pipeline unsmoothed within 1e-4, EnSI rtol 2e-4 / atol
  2e-3, ebe atol 2e-4 and utem atol 5e-4 with rtol 1e-4 (PERF.md §2).

Only the tests against gridpp_tpu import it (and so jax).
"""
import ast
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch.tools import bench  # noqa: E402

# tier-1 runs several test workers on a shared CPU
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--n", "64", "--obs", "200", "--members", "3",
         "--cycles", "2", "--repeats", "2"]
# the tiled Pipeline starts at 65,536 gridpoints: 256² takes the real
# general and resolve paths
TILED = ["--device", "cpu", "--n", "256", "--obs", "200", "--members", "2",
         "--cycles", "1", "--repeats", "1"]
ADDITIONS = {"backend", "device_name", "device_power_limit_w"}


def reference_keys():
    """(keys of bench.py's JSON line, the paths it benchmarks), read from
    bench.py's main(): the literal keys of `out`; for each key passed to
    bench_path, the constant f-string suffixes of `out[f"{key}..."]`; for
    each key passed to stream_rates, the suffixes of the loop that writes
    `out[f"{key}_{f}"]`."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    literal, called = set(), {"bench_path": [], "stream_rates": []}
    suffixes, looped = [], []
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [getattr(t, "id", None) for t in node.targets] == ["out"]:
            literal |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) \
                in called:
            called[node.func.id].append(node.args[0].value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            writes = [t for t in ast.walk(node)
                      if isinstance(t, ast.Subscript)
                      and getattr(t.value, "id", None) == "out"]
            if writes:
                looped += [c.value for c in node.iter.elts]
        if isinstance(node, ast.Subscript) \
                and getattr(node.value, "id", None) == "out" \
                and isinstance(node.slice, ast.JoinedStr):
            parts = node.slice.values
            if len(parts) == 2 and isinstance(parts[1], ast.Constant):
                suffixes.append(parts[1].value)
    keys = set(literal)
    keys |= {k + s for k in called["bench_path"] for s in suffixes}
    keys |= {f"{k}_{s}" for k in called["stream_rates"] for s in looped}
    return keys, called["bench_path"]


def test_reference_keys_read_from_bench_py():
    keys, paths = reference_keys()
    assert paths == list(bench.PATHS)
    assert {"metric", "value", "vs_baseline", "link_mb_per_s",
            "general_compute_pts_per_s", "ensi_multi_utem_d2h_s",
            "fast_serving_overlapped_pts_per_s",
            "ensi_serving_serial_pts_per_s"} <= keys
    assert "general_serving_serial_pts_per_s" not in keys
    assert len(keys) == 9 + 7 * 5 + 2 * 2


def test_output_keys_are_bench_pys_and_the_additions():
    keys, paths = reference_keys()
    want = keys | ADDITIONS | {f"{k}_compute_spread" for k in paths}
    assert len(bench.output_keys()) == len(want)
    assert set(bench.output_keys()) == want


def _run(argv, capsys):
    rc = bench.main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_tool_prints_every_key_of_bench_py(capsys):
    rc, out, err = _run(SMALL, capsys)
    assert rc == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    keys, paths = reference_keys()
    assert set(line) == keys | ADDITIONS | {f"{k}_compute_spread"
                                            for k in paths}
    assert list(line) == bench.output_keys()
    assert line["backend"] == "cpu" and line["device_name"] == "cpu"
    assert line["device_power_limit_w"] is None    # not measured: no card
    assert line["metric"] == "oi2000sq_plus_neighbourhood_gridpoints_per_s"
    numbers = {k: v for k, v in line.items()
               if k not in ("metric", "unit", "headline_note", "backend",
                            "device_name", "device_power_limit_w")}
    assert all(isinstance(v, float) and math.isfinite(v)
               for v in numbers.values()), numbers
    assert line["value"] == line["general_compute_pts_per_s"] > 0
    assert line["vs_baseline"] == line["value"] / 12_490.0
    assert line["fast_out_mb"] == 64 * 64 * 4 / 1e6
    assert line["ensi_out_mb"] == 64 * 64 * 3 * 4 / 1e6
    # each stage's seconds and each check on stderr
    for what in ("set-up Pipeline", "set-up MultiEnsiPipeline utem",
                 "ok: general == general_resolve bit for bit",
                 "ok: fast within 0.001 of general",
                 "serve_stream's 4 analyses equal the serial loop's",
                 "serve_stream's 3 analyses equal the serial loop's",
                 "K1 launched 0 times, 0 wanted", "the whole run:"):
        assert what in err, what


def test_problem_is_bench_pys_draws():
    """bench.py:57-69, :140-147 and :163-172 at n=200, p=500, seed 0, in
    its order, pback from gridpp_tpu.nearest on the CPU."""
    import gridpp_tpu as gj
    n, p, e = 200, 500, 10
    got = bench.problem(n, p, members=e)
    rng = np.random.default_rng(0)
    lats, lons = np.meshgrid(np.linspace(55, 62, n), np.linspace(5, 12, n),
                             indexing="ij")
    grid = gj.Grid(lats, lons)
    points = gj.Points(rng.uniform(55, 62, p), rng.uniform(5, 12, p),
                       np.zeros(p), np.zeros(p))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    pback = np.asarray(gj.nearest(grid, points, background))
    pobs = pback + rng.normal(0, 1, p).astype(np.float32)
    shifts = [np.float32(rng.integers(1 << 20)) for _ in range(4)]
    ens_np = rng.normal(280, 5, (n, n, 10)).astype(np.float32)
    ens_shifts = [np.float32(rng.integers(1 << 20)) for _ in range(2)]
    bg_ens = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    pobs_e = (pback[:, None] + rng.normal(0, 1, (p, e))).astype(np.float32)
    np.testing.assert_array_equal(got["grid"].lats, np.asarray(grid.lats))
    np.testing.assert_array_equal(got["grid"].lons, np.asarray(grid.lons))
    np.testing.assert_array_equal(got["points"].lats, np.asarray(points.lats))
    np.testing.assert_array_equal(got["points"].lons, np.asarray(points.lons))
    for key, want in (("background", background), ("pback", pback),
                      ("pobs", pobs), ("ens", ens_np), ("bg_ens", bg_ens),
                      ("pobs_e", pobs_e),
                      ("ratios", np.full(p, 0.1, np.float32)),
                      ("psig", np.full(p, 1.5, np.float32))):
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert got["shifts"] == shifts and got["ens_shifts"] == ens_shifts
    assert isinstance(got["structure"], gt.BarnesStructure)


@pytest.mark.parametrize("ulp", [False, True])
def test_tool_fails_when_general_and_resolve_part(ulp, monkeypatch, capsys):
    """One ulp on the resolve path's output fails the run (exit 1, no
    line); the same run without it passes."""
    if ulp:
        real = gt.Pipeline._run_resolve

        def one_ulp_up(self, *args):
            out = real(self, *args)
            return torch.nextafter(out, torch.full_like(out, math.inf))

        monkeypatch.setattr(gt.Pipeline, "_run_resolve", one_ulp_up)
    rc, out, err = _run(TILED, capsys)
    if ulp:
        assert rc == 1 and out == ""
        assert "check failed: general == general_resolve bit for bit" in err
    else:
        assert rc == 0, err
        assert "ok: general == general_resolve bit for bit" in err
        assert set(json.loads(out)) == set(bench.output_keys())


def test_tool_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    rc, out, err = _run([], capsys)
    assert rc == 2 and out == "" and "no CUDA card" in err


# -- serve_stream ------------------------------------------------------------
def _streams_like_calls(pipe, cycles):
    """serve_stream's yields, checked against a loop of __call__ bit for
    bit and in order."""
    streamed = list(pipe.serve_stream(cycles))
    assert len(streamed) == len(cycles)
    for got, args in zip(streamed, cycles):
        np.testing.assert_array_equal(got, pipe(*args))
    assert not np.array_equal(streamed[0], streamed[1])
    return streamed


@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("with_ratios", [False, True])
def test_pipeline_serve_stream(tiled, with_ratios):
    """Unsmoothed, so gridpp_tpu's serve_stream is the 1e-4 bar; with
    per-cycle ratios unlike the static ones, every cycle takes the general
    path."""
    from _torch_helpers import gj, objects, obs_values, problem
    prob = problem(3, nan_obs=0.0)
    kw = dict(halfwidth=0, max_points=6, ratios=prob["ratios"], tiled=tiled)
    g2, p2, st = objects(gt, prob)
    pipe = gt.Pipeline(g2, p2, st, device="cpu", **kw)
    _, pobs = obs_values(prob, g2)
    bg = prob["background"]
    cycles = [(bg + np.float32(i), pobs + np.float32(i))
              + ((prob["ratios"] * np.float32(1 + i),) if with_ratios
                 else ()) for i in range(4)]
    streamed = _streams_like_calls(pipe, cycles)
    grid, pts, sj = objects(gj, prob)
    ref = list(gj.Pipeline(grid, pts, sj, **kw).serve_stream(cycles))
    for got, want in zip(streamed, ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_ensi_serve_stream():
    from _torch_helpers import ens_problem, gj, objects
    prob = ens_problem(3, nan_obs=0.0, e=3)
    cycles = [(prob["background"] + np.float32(i), prob["pobs"],
               prob["psig"]) for i in range(4)]
    g2, p2, st = objects(gt, prob)
    streamed = _streams_like_calls(
        gt.EnsiPipeline(g2, p2, st, max_points=6, device="cpu"), cycles)
    grid, pts, sj = objects(gj, prob)
    ref = list(gj.EnsiPipeline(grid, pts, sj, max_points=6)
               .serve_stream(cycles))
    for got, want in zip(streamed, ref):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("variant,atol", [("utem", 5e-4), ("ebe", 2e-4)])
def test_multi_serve_stream(variant, atol):
    from _torch_helpers import ens_problem, gj, objects
    prob = ens_problem(4, nan_obs=0.0, e=4)
    pobs = prob["pobs"] if variant == "utem" else prob["pobs_e"]
    cycles = [(prob["background"] + np.float32(i), pobs, prob["ratios"],
               prob["background_corr"] + np.float32(i)) for i in range(4)]
    kw = dict(variant=variant, max_points=6, bratios=prob["bratios"])
    g2, p2, st = objects(gt, prob)
    streamed = _streams_like_calls(
        gt.MultiEnsiPipeline(g2, p2, st, device="cpu", **kw), cycles)
    grid, pts, sj = objects(gj, prob)
    ref = list(gj.MultiEnsiPipeline(grid, pts, sj, **kw)
               .serve_stream(cycles))
    for got, want in zip(streamed, ref):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
