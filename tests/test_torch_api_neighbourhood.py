"""The numpy neighbourhood API and ops/stats.py against gridpp_tpu.

gridpp_tpu_torch's top-level `neighbourhood` is the numpy API of
gridpp_tpu/api/neighbourhood.py, as gridpp_tpu's is: on an ensemble it first
collapses the member axis with the statistic, then takes the window. Both
packages route through the same native host kernels where gridpp_tpu does,
else through their own ops on the host, so results agree to the ops' bars
(tests/test_torch_neighbourhood.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt  # noqa: E402

from gridpp_tpu.ops import stats as jstats  # noqa: E402
from gridpp_tpu_torch.ops import stats as tstats  # noqa: E402

S = gj.Statistic
TOL = dict(rtol=1e-5, atol=1e-4)


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


@pytest.mark.parametrize("stat", [S.Mean, S.Max, S.Std])
def test_top_level_neighbourhood_is_the_numpy_api(stat):
    """The repaired fault: gridpp_tpu_torch.neighbourhood on a (Y, X, E)
    numpy field equals gridpp_tpu.neighbourhood in shape and values."""
    x = _field((40, 70, 5), seed=1)
    got = gt.neighbourhood(x, 3, stat)
    want = gj.neighbourhood(x, 3, stat)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape == (40, 70)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("stat", [S.Mean, S.Sum, S.Count, S.Min, S.Max,
                                  S.Std, S.Variance, S.Median])
@pytest.mark.parametrize("ens", [False, True])
def test_neighbourhood_matches_gridpp_tpu(stat, ens):
    x = _field((25, 30, 4) if ens else (25, 30), seed=int(stat))
    got = gt.neighbourhood(x, 2, stat)
    want = gj.neighbourhood(x, 2, stat)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("stat", [S.Mean, S.Min, S.Median, S.Variance])
@pytest.mark.parametrize("ens", [False, True])
def test_brute_force_matches_gridpp_tpu(stat, ens):
    x = _field((15, 18, 3) if ens else (15, 18), seed=7)
    np.testing.assert_allclose(gt.neighbourhood_brute_force(x, 2, stat),
                               gj.neighbourhood_brute_force(x, 2, stat),
                               **TOL)


@pytest.mark.parametrize("ens", [False, True])
def test_quantile_matches_gridpp_tpu(ens):
    x = _field((15, 18, 3) if ens else (15, 18), seed=8)
    for q in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(gt.neighbourhood_quantile(x, q, 2),
                                   gj.neighbourhood_quantile(x, q, 2),
                                   **TOL)
        np.testing.assert_allclose(gt.neighbourhood_quantile_ens(x, q, 2),
                                   gj.neighbourhood_quantile_ens(x, q, 2),
                                   **TOL)


@pytest.mark.parametrize("ens", [False, True])
def test_quantile_fast_matches_gridpp_tpu(ens):
    x = _field((20, 24, 3) if ens else (20, 24), seed=9)
    thr = gt.get_neighbourhood_thresholds(x, 9)
    np.testing.assert_array_equal(thr, gj.get_neighbourhood_thresholds(x, 9))
    qf = np.random.default_rng(3).random((20, 24)).astype(np.float32)
    for q in (0.5, np.array([[0.2]], np.float32), qf):
        got = gt.neighbourhood_quantile_fast(x, q, 2, thr)
        want = gj.neighbourhood_quantile_fast(x, q, 2, thr)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            gt.neighbourhood_quantile_ens_fast(x, q, 2, thr), want,
            rtol=1e-5, atol=1e-5)


def test_deprecated_aliases():
    x = _field((12, 14, 3), seed=4)
    np.testing.assert_allclose(gt.neighbourhood_ens(x, 1, S.Mean),
                               gj.neighbourhood_ens(x, 1, S.Mean), **TOL)


def test_random_choice_picks_a_window_value():
    x = _field((10, 12), seed=5)
    np.random.seed(0)
    out = gt.neighbourhood(x, 1, S.RandomChoice)
    assert out.shape == x.shape
    for (i, j) in [(0, 0), (4, 5), (9, 11)]:
        win = x[max(i - 1, 0):i + 2, max(j - 1, 0):j + 2]
        assert out[i, j] in win[np.isfinite(win)]
    xe = _field((10, 12, 3), seed=6)
    assert gt.neighbourhood(xe, 1, S.RandomChoice).shape == (10, 12)
    assert gt.neighbourhood_brute_force(xe, 1, S.RandomChoice).shape == (
        10, 12)


@pytest.mark.parametrize("call,match", [
    (lambda p: p.neighbourhood(np.zeros((5, 5)), 1, S.Quantile),
     "neighbourhood_quantile"),
    (lambda p: p.neighbourhood(np.zeros((5, 5, 2, 2)), 1, S.Mean),
     "2D or 3D"),
    (lambda p: p.neighbourhood_brute_force(np.zeros((5, 5)), -2, S.Mean),
     "Half width"),
    (lambda p: p.neighbourhood_quantile(np.zeros((5, 5)), 1.5, 1),
     "between 0 and 1"),
    (lambda p: p.neighbourhood_quantile_fast(np.zeros((5, 5)), 1.2, 1,
                                             [0.0, 1.0]),
     ">= 0 and <= 1"),
    (lambda p: p.neighbourhood_quantile_fast(np.zeros((5, 5)),
                                             np.zeros((2, 3)), 1, [0.0]),
     "same size"),
    (lambda p: p.get_neighbourhood_thresholds(np.zeros((5, 5)), 0),
     "num_thresholds"),
    (lambda p: p.neighbourhood("abc", 1, S.Mean), "convert"),
])
def test_errors_match_gridpp_tpu(call, match):
    for pkg in (gj, gt):
        with pytest.raises(ValueError, match=match):
            call(pkg)


def test_empty_inputs():
    for pkg in (gj, gt):
        assert pkg.neighbourhood(np.zeros((0, 0)), 1, S.Mean).shape == (0, 0)
        assert pkg.get_neighbourhood_thresholds(np.zeros(0), 3).size == 0
        out = pkg.neighbourhood_quantile_fast(np.zeros((3, 4)), 0.5, 1, [])
        assert out.shape == (3, 4) and np.isnan(out).all()


@pytest.mark.parametrize("stat", [S.Mean, S.Sum, S.Count, S.Std,
                                  S.Variance, S.Min, S.Median, S.Max])
def test_nan_statistic_matches_jax(stat):
    x = _field((30, 7), seed=int(stat))
    x[3] = np.nan
    got = tstats.nan_statistic(torch.as_tensor(x), int(stat)).numpy()
    want = np.asarray(jstats.nan_statistic(jnp.asarray(x), int(stat)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    got0 = tstats.nan_statistic(torch.as_tensor(x.T), int(stat),
                                axis=0).numpy()
    np.testing.assert_allclose(got0, got, rtol=0, atol=0)


def test_nan_quantile_matches_jax():
    x = _field((20, 9), seed=3)
    qf = np.random.default_rng(1).random(20).astype(np.float32)
    for q in (0.0, 0.25, 0.5, 1.0, np.nan, qf):
        got = tstats.nan_quantile(torch.as_tensor(x),
                                  torch.as_tensor(np.asarray(q))).numpy()
        want = np.asarray(jstats.nan_quantile(jnp.asarray(x),
                                              jnp.asarray(q)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert torch.isnan(tstats.nan_quantile(torch.zeros(3, 0), 0.5)).all()
    np.testing.assert_array_equal(
        tstats.valid_count(torch.as_tensor(x)).numpy(),
        np.asarray(jstats.valid_count(jnp.asarray(x))))


def test_nan_statistic_raises_like_jax():
    for mod, arr in ((tstats, torch.zeros(3, 4)), (jstats, jnp.zeros((3, 4)))):
        with pytest.raises(ValueError, match="quantile level"):
            mod.nan_statistic(arr, int(S.Quantile))
        with pytest.raises(ValueError, match="Cannot compute"):
            mod.nan_statistic(arr, int(S.RandomChoice))
    np.testing.assert_allclose(
        tstats.nan_statistic(torch.as_tensor(_field((6, 5))),
                             int(S.Quantile), quantile=0.3).numpy(),
        np.asarray(jstats.nan_statistic(jnp.asarray(_field((6, 5))),
                                        int(S.Quantile), quantile=0.3)),
        rtol=1e-6, atol=1e-6)


def test_calc_statistic_and_even_quantiles_match_gridpp_tpu():
    x = _field((6, 11), seed=2)
    for stat in (S.Mean, S.Std, S.Median, S.Count):
        np.testing.assert_allclose(gt.calc_statistic(x, stat),
                                   gj.calc_statistic(x, stat), rtol=1e-6)
        assert gt.calc_statistic(x[0], stat) == pytest.approx(
            gj.calc_statistic(x[0], stat), rel=1e-6, nan_ok=True)
    vals = np.round(_field((200,), seed=4, nan_frac=0.0))
    for num in (1, 2, 5, 17, 500):
        np.testing.assert_array_equal(gt.calc_even_quantiles(vals, num),
                                      gj.calc_even_quantiles(vals, num))


@pytest.mark.parametrize("stat", [S.Mean, S.Std, S.Median, S.Max])
def test_ops_route_without_native_engine(stat, monkeypatch):
    """Without the native host library the port's API takes its tensor ops
    on the host, and still agrees with gridpp_tpu (which uses the library
    here)."""
    from gridpp_tpu_torch import native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    x = _field((18, 21), seed=int(stat) + 1)
    tol = dict(rtol=2e-5, atol=2e-3) if stat == S.Std else TOL
    np.testing.assert_allclose(gt.neighbourhood(x, 2, stat),
                               gj.neighbourhood(x, 2, stat), **tol)
    np.testing.assert_allclose(gt.neighbourhood_brute_force(x, 2, stat),
                               gj.neighbourhood_brute_force(x, 2, stat),
                               **TOL)
    thr = gj.get_neighbourhood_thresholds(x, 7)
    np.testing.assert_allclose(gt.neighbourhood_quantile_fast(x, 0.4, 2, thr),
                               gj.neighbourhood_quantile_fast(x, 0.4, 2, thr),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gt.neighbourhood_quantile(x, 0.4, 2),
                               gj.neighbourhood_quantile(x, 0.4, 2), **TOL)
