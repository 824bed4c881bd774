"""Neighbourhood Mean/Sum/Count: the port's plain twin of kernel K1
against gridpp_tpu's XLA stencil and its Pallas kernel (interpret mode).

Bar: rtol 1e-5, atol 1e-4, as tests/test_pallas_stencil.py:36-38 (the
summation orders differ; each is an exact local sum). The CUDA kernel
itself is compared with the twin on a card, in tests/test_torch_cuda.py
and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gt  # noqa: E402

from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402

STATS = [Statistic.Mean, Statistic.Sum, Statistic.Count]
# tests/test_pallas_stencil.py:25-30, plus a halfwidth beyond the grid
SHAPES = [((40, 60), 3), ((17, 250), 7), ((300, 129), 1), ((31, 31), 0),
          ((256, 129), 7), ((160, 128), 3), ((256, 300), 7), ((12, 9), 20)]
TOL = dict(rtol=1e-5, atol=1e-4)


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("shape,h", SHAPES)
def test_twin_matches_jax(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = gt.neighbourhood(torch.as_tensor(x), h, int(stat)).numpy()
    xla = np.asarray(jnops.neighbourhood(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_mean(jnp.asarray(x), h, int(stat),
                                              interpret=True))
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(xla))


@pytest.mark.parametrize("stat", STATS)
def test_batched_planes_match_jax(stat):
    x = _field((3, 40, 70), seed=5)
    got = gt.neighbourhood(torch.as_tensor(x), 4, int(stat)).numpy()
    want = np.asarray(jnops.neighbourhood(jnp.asarray(x), 4, int(stat)))
    np.testing.assert_allclose(got, want, **TOL)


def test_all_missing_window():
    x = np.full((20, 20), np.nan, np.float32)
    x[0, 0] = 3.0
    t = torch.as_tensor(x)
    mean = gt.neighbourhood(t, 2, gt.Mean).numpy()
    assert mean[0, 0] == 3.0 and mean[2, 2] == 3.0
    assert np.isnan(mean[3, 0]) and np.isnan(mean[19, 19])
    count = gt.neighbourhood(t, 2, gt.Count).numpy()
    assert count[2, 2] == 1.0 and count[19, 19] == 0.0
    assert np.isnan(gt.neighbourhood(t, 2, gt.Sum).numpy()[19, 19])


@pytest.mark.parametrize("stat", [Statistic.Min, Statistic.Std,
                                  Statistic.Median])
def test_unported_statistics_raise(stat):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.neighbourhood(torch.zeros(8, 8), 2, int(stat))


def test_wrapper_rejects_unclipped_halfwidth():
    with pytest.raises(ValueError, match="clipped"):
        stencil.neighbourhood_mean_plain(torch.zeros(5, 5), 5, 1,
                                         int(Statistic.Mean))


def test_cpu_tensor_never_reaches_the_kernel():
    before = stencil.neighbourhood_mean_cuda.launches
    gt.neighbourhood(torch.as_tensor(_field((30, 30))), 3, gt.Mean)
    assert stencil.neighbourhood_mean_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_mean_cuda(torch.zeros(8, 8), 1, 1,
                                        int(Statistic.Mean))
