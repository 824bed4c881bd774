"""gridpp_tpu_torch's gridding, fill and doping (host code), masking
downscalers and fuzzy verification (api/gridding.py, api/fill.py,
api/masking.py, api/verif.py) against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- gridding, gridding_nearest, count, distance, fill, fill_missing,
  doping_square and doping_circle: host code on every route in both
  packages (numpy and the same native index), equal bit for bit, with the
  native library and with it switched off (scipy and numpy);
- downscale_probability and mask_threshold_downscale_consensus/_quantile
  (torch ops on the API's device in the port, numpy and jnp in
  gridpp_tpu): counts and order statistics equal, Mean/Sum/Std rtol 1e-5,
  atol 1e-5; the nearest map's tensors are the downscalers' cache;
- neighbourhood_score: K1's bars, rtol 1e-5, atol 1e-4 (tests/
  test_pallas_stencil.py:36-38), its four indicator planes smoothed in
  one neighbourhood call;
- the SWIG typemap test functions: equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu_torch.api.verif as tverif  # noqa: E402
import gridpp_tpu_torch.api.masking as tmask  # noqa: E402

BAR = dict(rtol=1e-5, atol=1e-5)
K1_BAR = dict(rtol=1e-5, atol=1e-4)


def _setup(pkg, seed, n=(30, 34), num=300):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(59, 60, n[0]),
                             np.linspace(10, 11.5, n[1]), indexing="ij")
    grid = pkg.Grid(lats, lons, rng.uniform(0, 800, lats.shape),
                    rng.uniform(0, 1, lats.shape))
    pts = pkg.Points(rng.uniform(58.95, 60.05, num),
                     rng.uniform(9.95, 11.55, num),
                     rng.uniform(0, 800, num), rng.uniform(0, 1, num))
    vals = rng.normal(5, 3, num).astype(np.float32)
    vals[rng.random(num) < 0.15] = np.nan
    field = rng.normal(280, 5, n).astype(np.float32)
    return grid, pts, vals, field


def _native_off(monkeypatch, *objs):
    """Switch the native index off on the given grids and points (their
    scipy and numpy paths)."""
    for obj in objs:
        index = obj.index
        monkeypatch.setattr(index, "_native", None)
        monkeypatch.setattr(index, "_native_tried", True)


def _both(fn, monkeypatch=None, native=True):
    out = {}
    for pkg in (gj, gt):
        grid, pts, vals, field = _setup(pkg, 1)
        if not native:
            _native_off(monkeypatch, grid, pts)
        out[pkg] = fn(pkg, grid, pts, vals, field)
    return out[gt], out[gj]


STATS = ["Mean", "Min", "Median", "Max", "Std", "Variance", "Sum", "Count",
         "Quantile"]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("target", ["grid", "points"])
def test_gridding_bit_for_bit(monkeypatch, native, stat, target):
    def fn(pkg, grid, pts, vals, field):
        tgt = grid if target == "grid" else pkg.Points(
            grid.get_lats()[::3, ::3].ravel(),
            grid.get_lons()[::3, ::3].ravel())
        return pkg.gridding(tgt, pts, vals, 6000.0, 2, getattr(pkg, stat))

    got, want = _both(fn, monkeypatch, native)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("min_num", [0, 1, 3])
@pytest.mark.parametrize("stat", ["Mean", "Sum", "Count", "Median", "Max",
                                  "Std"])
def test_gridding_nearest_bit_for_bit(stat, min_num):
    got, want = _both(lambda pkg, grid, pts, vals, field:
                      pkg.gridding_nearest(grid, pts, vals, min_num,
                                           getattr(pkg, stat)))
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("native", [True, False])
def test_count_and_distance_bit_for_bit(monkeypatch, native):
    def fn(pkg, grid, pts, vals, field):
        return np.concatenate([
            pkg.count(pts, grid, 5000.0).ravel(),
            pkg.count(grid, pts, 3000.0).ravel(),
            pkg.distance(pts, grid, 3).ravel(),
            pkg.distance(grid, pts, 1).ravel()])

    got, want = _both(fn, monkeypatch, native)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("outside", [False, True])
def test_fill_bit_for_bit(monkeypatch, native, outside):
    def fn(pkg, grid, pts, vals, field):
        radii = np.abs(np.random.default_rng(2).normal(0, 3000, pts.size()))
        return pkg.fill(grid, field, pts, radii, -5.0, outside)

    got, want = _both(fn, monkeypatch, native)
    assert np.array_equal(got, want, equal_nan=True)


def test_fill_missing_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (40, 33)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[:, 0] = np.nan
    x[5] = np.nan
    assert np.array_equal(gt.fill_missing(x), gj.fill_missing(x),
                          equal_nan=True)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["square", "circle"])
@pytest.mark.parametrize("max_elev_diff", [np.nan, 150.0])
def test_doping_bit_for_bit(monkeypatch, native, kind, max_elev_diff):
    def fn(pkg, grid, pts, vals, field):
        if not native:
            monkeypatch.setattr(pkg.api.fill.native, "doping_square",
                                lambda *a, **k: False)
        rng = np.random.default_rng(4)
        if kind == "square":
            return pkg.doping_square(grid, field, pts, vals,
                                     rng.integers(0, 3, pts.size()),
                                     max_elev_diff)
        return pkg.doping_circle(grid, field, pts, vals,
                                 rng.uniform(0, 4000, pts.size()),
                                 max_elev_diff)

    got, want = _both(fn, monkeypatch, native)
    assert np.array_equal(got, want, equal_nan=True)


def _ensemble(seed, shape=(25, 28), e=7):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(59, 60, shape[0]),
                             np.linspace(10, 11, shape[1]), indexing="ij")
    olats, olons = np.meshgrid(np.linspace(58.9, 60.1, 40),
                               np.linspace(9.9, 11.1, 37), indexing="ij")
    vals = [rng.gamma(1.0, 2.0, shape + (e,)).astype(np.float32)
            for _ in range(3)]
    for v in vals:
        v[rng.random(v.shape) < 0.1] = np.nan
    thr = rng.uniform(0.5, 3, olats.shape).astype(np.float32)
    return (lats, lons), (olats, olons), vals, thr


def _grids(pkg, src, dst):
    return pkg.Grid(*src), pkg.Grid(*dst)


@pytest.mark.parametrize("op", ["Lt", "Leq", "Gt", "Geq"])
def test_downscale_probability_bit_for_bit(op):
    src, dst, (v, _, _), thr = _ensemble(5)
    out = {pkg: pkg.downscale_probability(*_grids(pkg, src, dst), v, thr,
                                          getattr(pkg, op))
           for pkg in (gj, gt)}
    assert out[gt].dtype == np.float32 and out[gt].shape == (40, 37)
    assert np.array_equal(out[gt], out[gj], equal_nan=True)


@pytest.mark.parametrize("stat", ["Mean", "Sum", "Count", "Min", "Max",
                                  "Median", "Std", "Variance", "Quantile"])
@pytest.mark.parametrize("op", ["Lt", "Geq"])
def test_mask_threshold_downscale_matches_jax(stat, op):
    src, dst, (vt, vf, vthr), thr = _ensemble(6)
    out = {}
    for pkg in (gj, gt):
        ig, og = _grids(pkg, src, dst)
        if stat == "Quantile":
            out[pkg] = pkg.mask_threshold_downscale_quantile(
                ig, og, vt, vf, vthr, thr, getattr(pkg, op), 0.3)
        else:
            out[pkg] = pkg.mask_threshold_downscale_consensus(
                ig, og, vt, vf, vthr, thr, getattr(pkg, op),
                getattr(pkg, stat))
    assert np.array_equal(np.isnan(out[gt]), np.isnan(out[gj]))
    if stat in ("Count", "Min", "Max", "Median"):
        assert np.array_equal(out[gt], out[gj], equal_nan=True)
    else:
        np.testing.assert_allclose(out[gt], out[gj], **BAR)


def test_masking_gathers_through_the_downscalers_map_cache():
    src, dst, (v, vf, vthr), thr = _ensemble(7)
    ig, og = _grids(gt, src, dst)
    p = tmask.downscale_probability(ig, og, v, thr, gt.Gt)
    maps = ig.__dict__["_downscale_maps"][og]
    dev = torch.device("cpu")
    (flat,) = maps[("nearest", dev)]
    tmask.mask_threshold_downscale_consensus(ig, og, v, vf, vthr, thr,
                                             gt.Gt, gt.Mean)
    assert maps[("nearest", dev)][0] is flat
    assert np.array_equal(gt.nearest(ig, og, v[..., 0]),
                          v[..., 0].reshape(-1)[flat.numpy()].reshape(
                              og.size()), equal_nan=True)
    assert np.array_equal(p, gj.downscale_probability(
        *_grids(gj, src, dst), v, thr, gj.Gt), equal_nan=True)


@pytest.mark.parametrize("metric", ["Ets", "Ts", "Pc", "Kss", "Bias", "Hss"])
@pytest.mark.parametrize("h", [1, 4])
def test_neighbourhood_score_matches_jax(metric, h):
    out = {}
    calls = []
    for pkg in (gj, gt):
        grid, pts, vals, field = _setup(pkg, 8)
        fcst = np.random.default_rng(9).gamma(1.0, 3.0, field.shape).astype(
            np.float32)
        fcst[np.random.default_rng(10).random(field.shape) < 0.05] = np.nan
        if pkg is gt:
            real = tverif.nops.neighbourhood

            def smooth(x, *a):
                calls.append(tuple(x.shape))
                return real(x, *a)

            tverif.nops.neighbourhood, saved = smooth, real
        try:
            out[pkg] = pkg.neighbourhood_score(grid, pts, fcst, vals + 2, h,
                                               getattr(pkg, metric), 3.0)
        finally:
            if pkg is gt:
                tverif.nops.neighbourhood = saved
    assert calls == [(4,) + field.shape]
    assert out[gt].dtype == np.float32
    assert np.array_equal(np.isnan(out[gt]), np.isnan(out[gj]))
    np.testing.assert_allclose(out[gt], out[gj], **K1_BAR)


def test_neighbourhood_score_errors_match():
    for args in ((0,), (2, (5, 5))):
        def call(pkg):
            grid, pts, vals, field = _setup(pkg, 11)
            f = field if len(args) == 1 else np.ones(args[1], np.float32)
            return pkg.neighbourhood_score(grid, pts, f, vals, args[0],
                                           pkg.Ets, 1.0)

        with pytest.raises(ValueError) as ej:
            call(gj)
        with pytest.raises(ValueError) as et:
            call(gt)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name,args", [
    ("test_vec_input", ([1.5, 2.0],)), ("test_ivec_input", ([1, 2, 3],)),
    ("test_vec2_input", ([[1.0, 2.0]],)),
    ("test_vec3_input", ([[[1.0], [2.0]]],)), ("test_vec_output", ()),
    ("test_vec2_output", ()), ("test_vec3_output", ()),
    ("test_ivec_output", ()), ("test_ivec2_output", ()),
    ("test_ivec3_output", ()), ("test_vec_argout", ()),
    ("test_vec2_argout", ()), ("test_array", ([1, 2],))])
def test_swig_test_functions_equal(name, args):
    got = getattr(gt, name)(*args)
    want = getattr(gj, name)(*args)
    for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                    np.atleast_1d(np.asarray(want, dtype=object))):
        assert np.array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype
    with pytest.raises(NotImplementedError):
        gt.test_not_implemented_exception()


def test_top_level_helpers(capsys):
    gt.set_debug_level(3)
    assert gt.get_debug_level() == 3
    gt.set_debug_level(0)
    gt.set_omp_threads(4)
    gt.initialize_omp()
    assert gt.get_omp_threads() == gj.get_omp_threads() == 0
    assert abs(gt.clock() - gj.clock()) < 60
    gt.debug("x")
    gt.future_deprecation_warning("f", "g")
    gt.future_deprecation_warning("f")
    with pytest.raises(RuntimeError, match="boom"):
        gt.error("boom")
    out = capsys.readouterr().out
    gj.debug("x")
    gj.future_deprecation_warning("f", "g")
    gj.future_deprecation_warning("f")
    with pytest.raises(RuntimeError, match="boom"):
        gj.error("boom")
    assert capsys.readouterr().out == out
