"""gridpp_tpu_torch's calibration API (api/curves.py, ops/curves.py), its
transforms and util.cpp helpers against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- apply_curve, host route (the top-level, host-pinned function): both
  packages run the same native C++ curve, equal bit for bit, for a shared
  curve and per-cell curves under every pair of extrapolation policies;
- apply_curve, device route run on the CPU (`on_host` patched to False in
  the port's api.curves; gridpp_tpu's native curve switched off, which
  gives its jnp path): rtol 1e-6, atol 1e-4;
- ops.curves.piecewise_interp and ops.stats.interpolate against
  gridpp_tpu's: equal, on exact knots, repeated x (flat intervals inside
  and at either end of the curve) and NaN;
- the host copies (monotonize_curve, quantile_mapping_curve,
  get_optimal_threshold, metric_optimizer_curve, calc_score, the
  transforms' numpy forward/backward, util.cpp's helpers): equal;
- the transforms' tensor forms against their numpy forms: rtol 1e-6,
  atol 1e-4 (Gamma 1e-4 / 1e-4: torch.special against scipy.special).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt  # noqa: E402
import gridpp_tpu.native as jnative  # noqa: E402
import gridpp_tpu.ops.curves as jops  # noqa: E402
import gridpp_tpu.ops.stats as jstats  # noqa: E402
import gridpp_tpu_torch.api.curves as tapi  # noqa: E402
import gridpp_tpu_torch.ops.curves as tops  # noqa: E402
import gridpp_tpu_torch.ops.stats as tstats  # noqa: E402

RTOL, ATOL = 1e-6, 1e-4
POLICIES = ["OneToOne", "MeanSlope", "NearestSlope", "Zero", "Unchanged"]


def _curve(seed, c=11):
    """A sorted forecast curve with a repeated knot and its reference."""
    rng = np.random.default_rng(seed)
    cf = np.sort(rng.normal(280, 6, c)).astype(np.float32)
    cf[c // 2] = cf[c // 2 - 1]
    cr = np.sort(cf + rng.normal(1, 2, c)).astype(np.float32)
    return cr, cf


def _fcst(seed, shape):
    rng = np.random.default_rng(seed + 50)
    f = rng.normal(280, 9, shape).astype(np.float32)
    f[rng.random(shape) < 0.05] = np.nan
    return f


def _percell(seed, shape, c=7):
    rng = np.random.default_rng(seed + 60)
    cf = np.sort(rng.normal(280, 6, shape + (c,)), axis=-1).astype(
        np.float32)
    cf[..., 3] = cf[..., 2]
    cr = np.sort(cf + rng.normal(1, 2, cf.shape), axis=-1).astype(
        np.float32)
    return cr, cf


@pytest.mark.parametrize("below", POLICIES)
@pytest.mark.parametrize("above", POLICIES)
def test_apply_curve_host_route_bit_for_bit(below, above):
    pb, pa = int(getattr(gt, below)), int(getattr(gt, above))
    cr, cf = _curve(1)
    for fcst in (_fcst(1, (30, 40)), _fcst(2, (17,))):
        got = gt.apply_curve(fcst, cr, cf, pb, pa)
        want = gj.apply_curve(fcst, cr, cf, pb, pa)
        assert got.dtype == np.float32
        assert np.array_equal(got, want, equal_nan=True)
    fcst = _fcst(3, (20, 25))
    pr, pf = _percell(3, fcst.shape)
    assert np.array_equal(gt.apply_curve(fcst, pr, pf, pb, pa),
                          gj.apply_curve(fcst, pr, pf, pb, pa),
                          equal_nan=True)
    assert gt.apply_curve(270.5, cr, cf, pb, pa) == \
        gj.apply_curve(270.5, cr, cf, pb, pa)


@pytest.mark.parametrize("below", POLICIES)
@pytest.mark.parametrize("above", POLICIES)
def test_apply_curve_device_route_matches_jax(monkeypatch, below, above):
    pb, pa = int(getattr(gt, below)), int(getattr(gt, above))
    monkeypatch.setattr(jnative, "apply_curve", lambda *a: None)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    cr, cf = _curve(4)
    fcst = _fcst(4, (30, 40))
    pr, pf = _percell(4, fcst.shape)
    for curve in ((cr, cf), (pr, pf), (cr[:1], cf[:1])):
        got = tapi.apply_curve(fcst, *curve, pb, pa)
        want = gj.apply_curve(fcst, *curve, pb, pa)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert np.array_equal(np.isnan(got), np.isnan(want))


def _tie_cases():
    """(x, xp, fp): x on every knot, between knots and past both ends, on
    curves with a flat interval inside, at the lower end, at the upper end
    and across the whole curve."""
    xp_sets = [np.array([0, 1, 1, 2, 3], np.float32),
               np.array([0, 0, 1, 2, 3], np.float32),
               np.array([0, 1, 2, 3, 3], np.float32),
               np.array([2, 2, 2], np.float32),
               np.array([5], np.float32)]
    x = np.array([-1, 0, 0.5, 1, 1.5, 2, 2.5, 3, 4, 5, np.nan], np.float32)
    for xp in xp_sets:
        fp = np.arange(xp.size, dtype=np.float32) * 10 + 1
        yield x, xp, fp


def test_piecewise_interp_exact_ties_equal():
    import jax.numpy as jnp
    for x, xp, fp in _tie_cases():
        got = tops.piecewise_interp(torch.from_numpy(x), torch.from_numpy(xp),
                                    torch.from_numpy(fp)).numpy()
        want = np.asarray(jops.piecewise_interp(jnp.asarray(x),
                                                jnp.asarray(xp),
                                                jnp.asarray(fp)))
        assert np.array_equal(got, want, equal_nan=True), (xp, got, want)
        # the same curve per cell, by broadcast counting
        xpc = np.broadcast_to(xp, x.shape + xp.shape).copy()
        fpc = np.broadcast_to(fp, x.shape + fp.shape).copy()
        got_c = tops.piecewise_interp(torch.from_numpy(x),
                                      torch.from_numpy(xpc),
                                      torch.from_numpy(fpc)).numpy()
        want_c = np.asarray(jops.piecewise_interp(
            jnp.asarray(x), jnp.asarray(xpc), jnp.asarray(fpc)))
        assert np.array_equal(got_c, want_c, equal_nan=True)
        assert np.array_equal(got_c, got, equal_nan=True)
        st = tstats.interpolate(torch.from_numpy(x), torch.from_numpy(xp),
                                torch.from_numpy(fp)).numpy()
        sj = np.asarray(jstats.interpolate(jnp.asarray(x), jnp.asarray(xp),
                                           jnp.asarray(fp)))
        assert np.array_equal(st, sj, equal_nan=True)
        assert np.array_equal(gt.interpolate(x, xp, fp),
                              gj.interpolate(x, xp, fp), equal_nan=True)


def test_curve_construction_equal():
    rng = np.random.default_rng(5)
    ref = rng.gamma(2, 2, 400).astype(np.float32)
    fcst = (ref * 0.8 + rng.normal(0, 1, 400)).astype(np.float32)
    for q in ((), np.linspace(0, 1, 11)):
        for a, b in zip(gt.quantile_mapping_curve(ref, fcst, q),
                        gj.quantile_mapping_curve(ref, fcst, q)):
            assert np.array_equal(a, b)
    wiggly = np.array([1, 2, 3, 2.5, 2.8, 4, 5, 4.9, 6], np.float32)
    for a, b in zip(gt.monotonize_curve(wiggly * 2, wiggly),
                    gj.monotonize_curve(wiggly * 2, wiggly)):
        assert np.array_equal(a, b)
    thresholds = np.array([1, 2, 4, 6], np.float32)
    for metric in ("Ets", "Ts", "Kss", "Pc", "Bias", "Hss"):
        m = int(getattr(gt, metric))
        got = gt.get_optimal_threshold(ref, fcst, 3.0, m)
        want = gj.get_optimal_threshold(ref, fcst, 3.0, m)
        assert np.array_equal(got, want, equal_nan=True), metric
        for a, b in zip(gt.metric_optimizer_curve(ref, fcst, thresholds, m),
                        gj.metric_optimizer_curve(ref, fcst, thresholds, m)):
            assert np.array_equal(a, b)
        assert np.array_equal(gt.calc_score(ref, fcst, 3.0, m),
                              gj.calc_score(ref, fcst, 3.0, m),
                              equal_nan=True)
        assert np.array_equal(gt.calc_score(ref, fcst, 3.0, 2.5, m),
                              gj.calc_score(ref, fcst, 3.0, 2.5, m),
                              equal_nan=True)
        for abcd in ((3, 1, 2, 10), (0, 0, 0, 5), (2, 2, 0, 0)):
            assert np.array_equal(gt.calc_score(*abcd, m),
                                  gj.calc_score(*abcd, m), equal_nan=True)


def _transforms(pkg):
    return [pkg.Identity(), pkg.Log(), pkg.BoxCox(0.0), pkg.BoxCox(0.3),
            pkg.StartedBoxCox(0.5, 2.0), pkg.Gamma(1.5, 2.0),
            pkg.Gamma(0.7, 1.0, 0.1)]


def test_transforms_numpy_equal_and_tensor_forms_match():
    rng = np.random.default_rng(6)
    x = rng.gamma(2, 2, 300).astype(np.float32)
    x[:5] = [0, np.nan, 1e-3, 2.0, 30.0]
    z = rng.normal(0, 1, 300).astype(np.float32)
    for t, j in zip(_transforms(gt), _transforms(gj)):
        fwd = t.forward(x)
        assert np.array_equal(fwd, j.forward(x), equal_nan=True)
        assert np.array_equal(t.backward(z), j.backward(z), equal_nan=True)
        assert t.forward(2.5) == j.forward(2.5)
        tol = (1e-4, 1e-4) if isinstance(t, gt.Gamma) else (RTOL, ATOL)
        ft = t.forward_tensor(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ft, fwd, rtol=tol[0], atol=tol[1])
        bt = t.backward_tensor(torch.from_numpy(fwd)).numpy()
        np.testing.assert_allclose(bt, t.backward(fwd), rtol=tol[0],
                                   atol=tol[1])


def test_gamma_backward_has_no_device_form():
    """torch has no inverse incomplete gamma: Gamma.backward_tensor takes a
    CPU tensor through numpy and raises for any other device."""
    g = gt.Gamma(1.5, 2.0)
    with pytest.raises(NotImplementedError):
        g.backward_tensor(torch.zeros(3, device="meta"))
    assert g.forward_tensor(torch.zeros(3, device="meta")).device.type == \
        "meta"


def test_transform_errors_match():
    for args in ((0, 1), (1, 0), (1, 1, -1)):
        with pytest.raises(ValueError) as ej:
            gj.Gamma(*args)
        with pytest.raises(ValueError) as et:
            gt.Gamma(*args)
        assert str(et.value) == str(ej.value)
    for args in ((0, 1), (1, 0)):
        with pytest.raises(ValueError) as ej:
            gj.StartedBoxCox(*args)
        with pytest.raises(ValueError) as et:
            gt.StartedBoxCox(*args)
        assert str(et.value) == str(ej.value)


def test_util_helpers_equal():
    rng = np.random.default_rng(7)
    a = rng.normal(0, 1, (6, 9)).astype(np.float32)
    a[a > 1.2] = np.nan
    q3 = rng.uniform(0, 1, (6, 9)).astype(np.float32)
    a3 = rng.normal(0, 1, (6, 9, 5)).astype(np.float32)
    for args in ((a[0], 0.3), (a, 0.7), (a, np.nan), (a3, q3)):
        assert np.array_equal(gt.calc_quantile(*args),
                              gj.calc_quantile(*args), equal_nan=True)
    vals = np.array([0, 1, 1, 2, np.nan, 3], np.float32)
    for x in (-1, 0, 1, 1.5, 3, 4):
        assert gt.get_lower_index(x, vals) == gj.get_lower_index(x, vals)
        assert gt.get_upper_index(x, vals) == gj.get_upper_index(x, vals)
    assert gt.num_missing_values(a) == gj.num_missing_values(a)
    for f in ("init_vec2", "init_ivec2"):
        assert np.array_equal(getattr(gt, f)(3, 4, 2),
                              getattr(gj, f)(3, 4, 2))
    for f in ("init_vec3", "init_ivec3"):
        assert np.array_equal(getattr(gt, f)(3, 4, 2, 5),
                              getattr(gj, f)(3, 4, 2, 5))
    lats, lons = rng.uniform(-80, 80, 7), rng.uniform(-170, 170, 7)
    for got, want in zip(gt.convert_coordinates(lats, lons),
                         gj.convert_coordinates(lats, lons)):
        assert np.array_equal(got, want)
    assert gt.convert_coordinates(60.0, 10.0) == \
        gj.convert_coordinates(60.0, 10.0)
    for lat in (45, 91, np.nan):
        assert gt.is_valid_lat(lat) == gj.is_valid_lat(lat)
        assert gt.is_valid_lon(lat) == gj.is_valid_lon(lat)
    corners = [(0, 0), (0, 1), (1, 1), (1, 0)]
    for m in ((0.5, 0.5), (1.5, 0.5), (1, 1)):
        got = gt.point_in_rectangle(*[gt.Point(*c) for c in corners],
                                    gt.Point(*m))
        want = gj.point_in_rectangle(*[gj.Point(*c) for c in corners],
                                     gj.Point(*m))
        assert got == want
    g_t = gt.Grid(*np.meshgrid(np.arange(3.0), np.arange(4.0),
                               indexing="ij"))
    g_j = gj.Grid(*np.meshgrid(np.arange(3.0), np.arange(4.0),
                               indexing="ij"))
    for b in (np.zeros((3, 4)), np.zeros((2, 3, 4)), np.zeros((3, 3)),
              np.zeros((0, 0))):
        assert gt.compatible_size(g_t, b) == gj.compatible_size(g_j, b)
    assert gt.compatible_size(np.zeros((2, 3)), np.zeros((2, 3, 4))) == \
        gj.compatible_size(np.zeros((2, 3)), np.zeros((2, 3, 4)))
