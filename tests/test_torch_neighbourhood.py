"""ops.neighbourhood: the port's tensor ops on CPU tensors (the plain
versions of kernels K1-K4, and the brute force) against gridpp_tpu's XLA
path and its Pallas kernels in interpret mode.

Bars (tests/test_pallas_stencil.py): Mean/Sum/Count rtol 1e-5, atol 1e-4
(:36-38; the summation orders differ, each is an exact local sum);
Min/Max exact (an order-free reduction); Std/Variance rtol 2e-5, atol 2e-3
(:220); quantile_fast rtol/atol 1e-5 (:67) and equal on exact cdf ties
(:70-85). The CUDA kernels are held to these plain versions on a card, in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gt  # noqa: E402,F401

from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402
from gridpp_tpu_torch.ops import neighbourhood as tops  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402

STATS = [Statistic.Mean, Statistic.Sum, Statistic.Count]
# tests/test_pallas_stencil.py:25-30, plus a halfwidth beyond the grid
SHAPES = [((40, 60), 3), ((17, 250), 7), ((300, 129), 1), ((31, 31), 0),
          ((256, 129), 7), ((160, 128), 3), ((256, 300), 7), ((12, 9), 20)]
TOL = dict(rtol=1e-5, atol=1e-4)
VAR_TOL = dict(rtol=2e-5, atol=2e-3)
QF_TOL = dict(rtol=1e-5, atol=1e-5)
TOLS = {Statistic.Mean: TOL, Statistic.Sum: TOL, Statistic.Count: TOL,
        Statistic.Min: dict(rtol=0, atol=0), Statistic.Max: dict(rtol=0,
                                                                 atol=0),
        Statistic.Std: VAR_TOL, Statistic.Variance: VAR_TOL,
        Statistic.Median: dict(rtol=0, atol=0)}


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _ops(x, h, stat):
    return tops.neighbourhood(torch.as_tensor(x), h, int(stat)).numpy()


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("shape,h", SHAPES)
def test_twin_matches_jax(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = _ops(x, h, stat)
    xla = np.asarray(jnops.neighbourhood(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_mean(jnp.asarray(x), h, int(stat),
                                              interpret=True))
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(xla))


@pytest.mark.parametrize("stat", list(TOLS))
def test_batched_planes_match_jax(stat):
    x = _field((3, 40, 70), seed=5)
    got = _ops(x, 4, stat)
    want = np.asarray(jnops.neighbourhood(jnp.asarray(x), 4, int(stat)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOLS[stat])


@pytest.mark.parametrize("stat", [Statistic.Min, Statistic.Max,
                                  Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((31, 31), 0), ((12, 9), 20)])
def test_stencil_statistics_match_jax(stat, shape, h):
    """Min/Max (K2's plain version) and Std/Variance (K3's) through the
    ops dispatch against gridpp_tpu's XLA path. At h=0 the reference's
    Pallas kernels define Std/Variance (0 where finite): XLA on the CPU
    contracts E[x^2] - E[x]^2 into an FMA there and leaves ulp noise."""
    x = _field(shape, seed=int(stat) + h)
    got = _ops(x, h, stat)
    if h == 0 and stat in (Statistic.Std, Statistic.Variance):
        want = np.asarray(ps.neighbourhood_var(jnp.asarray(x), 0, int(stat)))
    else:
        want = np.asarray(jnops.neighbourhood(jnp.asarray(x), h, int(stat)))
    np.testing.assert_allclose(got, want, **TOLS[stat])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("stat", [Statistic.Median, Statistic.Min,
                                  Statistic.Std])
@pytest.mark.parametrize("shape,h", [((20, 30), 2), ((9, 14), 20)])
def test_brute_force_matches_jax(stat, shape, h):
    x = _field(shape, seed=3 + h)
    got = tops.neighbourhood_brute_force(torch.as_tensor(x), h,
                                         int(stat)).numpy()
    want = np.asarray(jnops.neighbourhood_brute_force(jnp.asarray(x), h,
                                                      int(stat)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_median_dispatch_matches_jax():
    x = _field((2, 25, 30), seed=8)
    np.testing.assert_array_equal(
        _ops(x, 2, Statistic.Median),
        np.asarray(jnops.neighbourhood(jnp.asarray(x), 2,
                                       int(Statistic.Median))))


@pytest.mark.parametrize("q", [0.0, 0.3, 0.5, 1.0, np.nan])
def test_brute_force_quantile_matches_jax(q):
    x = _field((20, 25), seed=4)
    got = tops.neighbourhood_quantile(torch.as_tensor(x), q, 2).numpy()
    want = np.asarray(jnops.neighbourhood_quantile(jnp.asarray(x), q, 2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xe = _field((12, 14, 3), seed=5)
    got = tops.neighbourhood_quantile_ens(torch.as_tensor(xe), q, 1).numpy()
    want = np.asarray(jnops.neighbourhood_quantile_ens(jnp.asarray(xe), q,
                                                       1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_brute_force_ens_matches_jax():
    xe = _field((12, 14, 3), seed=6)
    for stat in (Statistic.Mean, Statistic.Median, Statistic.Variance):
        got = tops.neighbourhood_brute_force_ens(torch.as_tensor(xe), 2,
                                                 int(stat)).numpy()
        want = np.asarray(jnops.neighbourhood_brute_force_ens(
            jnp.asarray(xe), 2, int(stat)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape,h,t", [((40, 60), 3, 11), ((17, 140), 7, 5),
                                       ((33, 33), 2, 20), ((24, 24), 0, 7),
                                       ((40, 60), 8, 11), ((40, 60), 7, 1),
                                       ((40, 60), 7, 4), ((36, 50), 8, 5),
                                       ((40, 60), 7, 33)])
def test_quantile_fast_matches_jax(q, shape, h, t):
    """K4's plain version against gridpp_tpu's XLA path and its Pallas
    kernel (tests/test_pallas_stencil.py:54-67); the Pallas kernel packs
    4 counts to an int32 at h=7 and 2 at h=8, as K4 does."""
    x = _field(shape, seed=h + t)
    thr = np.quantile(x[np.isfinite(x)],
                      np.linspace(0, 1, t)).astype(np.float32)
    got = tops.neighbourhood_quantile_fast(torch.as_tensor(x), q, h,
                                           torch.as_tensor(thr)).numpy()
    xla = np.asarray(jnops.neighbourhood_quantile_fast(
        jnp.asarray(x), q, h, jnp.asarray(thr)))
    pallas = np.asarray(ps.neighbourhood_quantile_fast(
        jnp.asarray(x), q, h, jnp.asarray(thr), interpret=True))
    np.testing.assert_allclose(got, xla, **QF_TOL)
    np.testing.assert_allclose(got, pallas, **QF_TOL)


@pytest.mark.parametrize("q", [float(np.float32(1.0 / 3.0)), 0.5, 0.25,
                               float(np.float32(2.0 / 9.0))])
def test_quantile_fast_exact_cdf_ties(q):
    """q on attainable cdf values (tests/test_pallas_stencil.py:70-85): the
    bracket must come from the same f32 comparisons, bit for bit."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 5, (30, 40)).astype(np.float32)
    x[4, 7] = np.nan
    thr = np.arange(5, dtype=np.float32)
    got = tops.neighbourhood_quantile_fast(torch.as_tensor(x), q, 1,
                                           torch.as_tensor(thr)).numpy()
    want = np.asarray(jnops.neighbourhood_quantile_fast(
        jnp.asarray(x), q, 1, jnp.asarray(thr)))
    np.testing.assert_array_equal(got, want)


def test_quantile_fast_ensemble_and_per_cell_q():
    xe = _field((20, 24, 4), seed=12)
    thr = np.linspace(-20, 20, 9).astype(np.float32)
    qf = np.random.default_rng(13).random((20, 24)).astype(np.float32)
    qf[3, 4] = np.nan
    for x, q in ((xe, 0.4), (xe, qf), (xe[:, :, 0], qf)):
        qt = q if np.ndim(q) == 0 else torch.as_tensor(q)
        got = tops.neighbourhood_quantile_fast(
            torch.as_tensor(x), qt, 2, torch.as_tensor(thr)).numpy()
        want = np.asarray(jnops.neighbourhood_quantile_fast(
            jnp.asarray(x), jnp.asarray(q), 2, jnp.asarray(thr)))
        assert got.shape == (20, 24)
        np.testing.assert_allclose(got, want, **QF_TOL)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_quantile_fast_nan_quantile_and_all_nan_region():
    x = _field((40, 50), seed=3)
    x[10:20, 10:30] = np.nan
    thr = np.linspace(-30, 30, 9).astype(np.float32)
    got = tops.neighbourhood_quantile_fast(torch.as_tensor(x), 0.5, 2,
                                           torch.as_tensor(thr)).numpy()
    want = np.asarray(ps.neighbourhood_quantile_fast(
        jnp.asarray(x), 0.5, 2, jnp.asarray(thr), interpret=True))
    np.testing.assert_allclose(got, want, **QF_TOL)
    assert np.isnan(got[14:16, 14:26]).all()
    nan_q = tops.neighbourhood_quantile_fast(torch.as_tensor(x), np.nan, 2,
                                             torch.as_tensor(thr)).numpy()
    assert np.isnan(nan_q).all()


def test_interp_quantile_from_cdf_matches_jax():
    rng = np.random.default_rng(2)
    cdf = np.sort(rng.random((6, 7, 5)), axis=-1).astype(np.float32)
    cdf[..., 2] = cdf[..., 1]  # a flat interval
    cdf[0, 0] = np.nan
    thr = np.linspace(0, 4, 5).astype(np.float32)
    for q in (0.0, 0.5, cdf[1, 1, 1], 1.0):
        got = tops.interp_quantile_from_cdf(
            q, torch.as_tensor(cdf), torch.as_tensor(thr)).numpy()
        want = np.asarray(jnops.interp_quantile_from_cdf(
            q, jnp.asarray(cdf), jnp.asarray(thr)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["window_sum", "window_count", "window_min",
                                "window_max"])
@pytest.mark.parametrize("h", [0, 3])
def test_window_functions_match_jax(fn, h):
    x = _field((25, 33), seed=9)
    got = getattr(tops, fn)(torch.as_tensor(x), h).numpy()
    want = np.asarray(getattr(jnops, fn)(jnp.asarray(x), h))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("stat", list(TOLS))
def test_all_nan_region(stat):
    x = _field((30, 30), seed=1)
    x[5:20, 5:20] = np.nan
    got = _ops(x, 2, stat)
    want = np.asarray(jnops._xla_basic(jnp.asarray(x), 2, int(stat)))
    inner = slice(8, 17)
    if stat == Statistic.Count:
        assert (got[inner, inner] == 0).all()
    else:
        assert np.isnan(got[inner, inner]).all()
    np.testing.assert_allclose(got, want, **TOLS[stat])


def test_all_missing_window():
    x = np.full((20, 20), np.nan, np.float32)
    x[0, 0] = 3.0
    t = torch.as_tensor(x)
    mean = tops.neighbourhood(t, 2, gt.Mean).numpy()
    assert mean[0, 0] == 3.0 and mean[2, 2] == 3.0
    assert np.isnan(mean[3, 0]) and np.isnan(mean[19, 19])
    count = tops.neighbourhood(t, 2, gt.Count).numpy()
    assert count[2, 2] == 1.0 and count[19, 19] == 0.0
    assert np.isnan(tops.neighbourhood(t, 2, gt.Sum).numpy()[19, 19])
    mx = tops.neighbourhood(t, 2, gt.Max).numpy()
    assert mx[2, 2] == 3.0 and np.isnan(mx[19, 19])


@pytest.mark.parametrize("call,match", [
    (lambda: tops.neighbourhood(torch.zeros(8, 8), 2,
                                int(Statistic.Quantile)),
     "requires a quantile level"),
    (lambda: tops.neighbourhood(torch.zeros(8, 8), 2,
                                int(Statistic.RandomChoice)),
     "Cannot compute statistic"),
    (lambda: gt.neighbourhood(np.zeros((8, 8), np.float32), -1,
                              gt.Mean),
     "Half width"),
])
def test_unported_statistics_raise(call, match):
    """What still raises, with gridpp_tpu's ValueError: Quantile without a
    level and RandomChoice in the ops layer (nan_statistic), a negative
    halfwidth in the numpy API (_check_halfwidth)."""
    with pytest.raises(ValueError, match=match):
        call()


def test_wrapper_rejects_unclipped_halfwidth():
    with pytest.raises(ValueError, match="clipped"):
        stencil.neighbourhood_mean_plain(torch.zeros(5, 5), 5, 1,
                                         int(Statistic.Mean))


def test_cpu_tensor_never_reaches_the_kernel():
    counters = [stencil.neighbourhood_mean_cuda,
                stencil.neighbourhood_minmax_cuda,
                stencil.neighbourhood_var_cuda,
                stencil.neighbourhood_quantile_fast_cuda]
    before = [f.launches for f in counters]
    x = torch.as_tensor(_field((30, 30)))
    for stat in (gt.Mean, gt.Max, gt.Std):
        tops.neighbourhood(x, 3, stat)
    tops.neighbourhood_quantile_fast(x, 0.5, 3, torch.linspace(-9, 9, 5))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_mean_cuda(torch.zeros(8, 8), 1, 1,
                                        int(Statistic.Mean))


def _field_280(shape, seed):
    """The benchmark's background, normal(280, 5), 10% missing. Windows past
    h=80 sum thousands of cells: on a zero-mean field the sum cancels below
    the f32 rounding of its partial sums, so the wide cases use this field
    (its anomaly for Std/Variance, tests/test_torch_pipeline.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(280, 5, shape).astype(np.float32)
    x[rng.random(shape) < 0.1] = np.nan
    return x


@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Sum,
                                  Statistic.Count, Statistic.Min,
                                  Statistic.Max, Statistic.Std,
                                  Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((230, 330), 81), ((230, 330), 100),
                                     ((320, 330), 150)])
def test_wide_halfwidths_match_jax(stat, shape, h):
    """Wide unclipped halfwidths, where the card takes the wide route: the
    plain versions, which the card is held to, against gridpp_tpu's XLA
    path."""
    x = _field_280(shape, seed=h)
    if stat in (Statistic.Std, Statistic.Variance):
        x = x - np.float32(280.0)
    got = _ops(x, h, stat)
    want = np.asarray(jnops._xla_basic(jnp.asarray(x), h, int(stat)))
    np.testing.assert_allclose(got, want, **TOLS[stat])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("shape", [(230, 330), (320, 330)])
def test_quantile_fast_wide_halfwidth_matches_jax(q, shape):
    """K4's plain version at h=120, where the card takes its wide route,
    against gridpp_tpu's XLA path (tests/test_pallas_stencil.py:67)."""
    x = _field(shape, seed=120)
    thr = np.quantile(x[np.isfinite(x)],
                      np.linspace(0, 1, 11)).astype(np.float32)
    got = tops.neighbourhood_quantile_fast(torch.as_tensor(x), q, 120,
                                           torch.as_tensor(thr)).numpy()
    want = np.asarray(jnops.neighbourhood_quantile_fast(
        jnp.asarray(x), q, 120, jnp.asarray(thr)))
    np.testing.assert_allclose(got, want, **QF_TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_members_wide_halfwidth_matches_jax():
    """K5's plain version at h=150 on (320, 330, 3), per member against
    gridpp_tpu's XLA path."""
    x = _field_280((320, 330, 3), seed=150)
    for stat in (Statistic.Mean, Statistic.Count, Statistic.Max):
        got = stencil.neighbourhood_members(torch.as_tensor(x), 150,
                                            int(stat)).numpy()
        for k in range(3):
            want = np.asarray(jnops._xla_basic(jnp.asarray(x[:, :, k]), 150,
                                               int(stat)))
            np.testing.assert_allclose(got[:, :, k], want, **TOLS[stat])


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("t", [5, 11])
def test_quantile_fast_past_the_crossover_matches_jax(q, t):
    """K4's plain version at h=8, where a window's 289 cells no longer fit
    8-bit count lanes (the card's K4 takes its wide route at every
    halfwidth), against gridpp_tpu's XLA path and its Pallas kernel in
    interpret mode (tests/test_pallas_stencil.py:54-67)."""
    h = 8
    x = _field((70, 90), seed=h + t)
    x[20:30, 40:60] = np.nan
    thr = np.quantile(x[np.isfinite(x)],
                      np.linspace(0, 1, t)).astype(np.float32)
    assert stencil.stencil_plan("K4", x.shape, h, h, t=t).route == "wide"
    got = tops.neighbourhood_quantile_fast(torch.as_tensor(x), q, h,
                                           torch.as_tensor(thr)).numpy()
    xla = np.asarray(jnops.neighbourhood_quantile_fast(
        jnp.asarray(x), q, h, jnp.asarray(thr)))
    pallas = np.asarray(ps.neighbourhood_quantile_fast(
        jnp.asarray(x), q, h, jnp.asarray(thr), interpret=True))
    np.testing.assert_allclose(got, xla, **QF_TOL)
    np.testing.assert_allclose(got, pallas, **QF_TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(xla))


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("h", [3, 7])
def test_var_plain_on_ten_planes_matches_jax(stat, h):
    """K3's plain version on EnsiPipeline's ten (E, Y, X) member planes of
    an anomaly field, which the card smooths in one K3 launch, against
    gridpp_tpu's neighbourhood_var (its Pallas kernel in interpret mode)
    and its XLA route, plane by plane."""
    x = _field_280((10, 36, 50), seed=h) - np.float32(280.0)
    got = _ops(x, h, stat)
    assert got.shape == x.shape
    for b in range(x.shape[0]):
        pallas = np.asarray(ps.neighbourhood_var(jnp.asarray(x[b]), h,
                                                 int(stat), interpret=True))
        xla = np.asarray(jnops._xla_basic(jnp.asarray(x[b]), h, int(stat)))
        for want in (pallas, xla):
            np.testing.assert_allclose(got[b], want, **VAR_TOL)
            np.testing.assert_array_equal(np.isnan(got[b]), np.isnan(want))
