"""The plain versions of kernels K2, K3 and K5 (ops/stencil.py) against
gridpp_tpu's Pallas kernels in interpret mode and its XLA stencil.

Bars (tests/test_pallas_stencil.py): Min/Max exact against XLA and 1e-6
against Pallas (:51); Std/Variance rtol 2e-5, atol 2e-3 (:220); members
rtol 1e-5, atol 1e-4 for Mean/Count and exact for Min/Max (:199). K4's plain
version is ops/neighbourhood.py::_quantile_fast_xla, tested in
tests/test_torch_neighbourhood.py. The kernels themselves are held to these
plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gt  # noqa: E402,F401

from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _clip(shape, h):
    return min(h, shape[-2] - 1), min(h, shape[-1] - 1)


@pytest.mark.parametrize("stat", [Statistic.Min, Statistic.Max])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((300, 129), 1), ((64, 64), 5),
                                     ((160, 128), 3)])
def test_minmax_plain_matches_pallas(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_minmax_plain(torch.as_tensor(x),
                                             *_clip(shape, h),
                                             int(stat)).numpy()
    xla = np.asarray(jnops._xla_basic(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_minmax(jnp.asarray(x), h, int(stat),
                                                interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((256, 300), 7)])
def test_var_plain_matches_pallas(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_var_plain(torch.as_tensor(x),
                                          *_clip(shape, h),
                                          int(stat)).numpy()
    xla = np.asarray(jnops._xla_basic(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_var(jnp.asarray(x), h, int(stat),
                                             interpret=True))
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-3)


def test_var_plain_is_unclamped():
    """E[x^2] - E[x]^2 stays as computed (neighbourhood.cpp:211-235): on a
    constant field its rounding may leave it just below 0, and Std is NaN
    there, in both packages' two-pass form."""
    x = np.full((12, 12), np.float32(0.1), np.float32)
    var = stencil.neighbourhood_var_plain(torch.as_tensor(x), 2, 2,
                                          int(Statistic.Variance)).numpy()
    s = torch.as_tensor(x) * 1.0
    mean = stencil.neighbourhood_mean_plain(s, 2, 2, int(Statistic.Mean))
    mean2 = stencil.neighbourhood_mean_plain(s * s, 2, 2,
                                             int(Statistic.Mean))
    np.testing.assert_array_equal(var, (mean2 - mean * mean).numpy())
    std = stencil.neighbourhood_var_plain(torch.as_tensor(x), 2, 2,
                                          int(Statistic.Std)).numpy()
    np.testing.assert_array_equal(np.isnan(std), var < 0)


MEMBER_TOL = {Statistic.Mean: dict(rtol=1e-5, atol=1e-4),
              Statistic.Count: dict(rtol=1e-5, atol=1e-4),
              Statistic.Sum: dict(rtol=1e-5, atol=1e-4),
              Statistic.Min: dict(rtol=0, atol=0),
              Statistic.Max: dict(rtol=0, atol=0)}


@pytest.mark.parametrize("shape,h", [((40, 60, 4), 3), ((17, 250, 2), 7),
                                     ((31, 31, 6), 0)])
@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Count,
                                  Statistic.Min, Statistic.Max])
def test_members_matches_pallas(shape, h, stat):
    """K5's plain version against gridpp_tpu's member kernel
    (tests/test_pallas_stencil.py:185-199) and its per-member XLA path."""
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_members(torch.as_tensor(x), h,
                                        int(stat)).numpy()
    pallas = np.asarray(ps.neighbourhood_members(jnp.asarray(x), h,
                                                 int(stat), interpret=True))
    per_member = np.stack(
        [np.asarray(jnops._xla_basic(jnp.asarray(x[:, :, k]), h, int(stat)))
         for k in range(shape[2])], axis=2)
    assert got.shape == shape
    np.testing.assert_allclose(got, pallas, **MEMBER_TOL[stat])
    np.testing.assert_allclose(got, per_member, **MEMBER_TOL[stat])


@pytest.mark.parametrize("stat", [Statistic.Sum, Statistic.Max])
def test_members_equal_per_member_planes(stat):
    """Every member of K5's output is K1's or K2's output on that member."""
    x = torch.as_tensor(_field((23, 37, 5), seed=2))
    got = stencil.neighbourhood_members(x, 4, int(stat))
    plain = (stencil.neighbourhood_minmax_plain
             if stat == Statistic.Max else stencil.neighbourhood_mean_plain)
    for k in range(5):
        torch.testing.assert_close(got[:, :, k],
                                   plain(x[:, :, k], 4, 4, int(stat)),
                                   equal_nan=True, rtol=0, atol=0)


def test_members_rejects_what_it_cannot_take():
    x = torch.zeros((8, 9, 3))
    with pytest.raises(ValueError, match="is not Mean"):
        stencil.neighbourhood_members(x, 2, int(Statistic.Std))
    with pytest.raises(ValueError, match=r"\(Y, X, E\)"):
        stencil.neighbourhood_members(x[:, :, 0], 2, int(Statistic.Mean))
    with pytest.raises(ValueError, match="halfwidth"):
        stencil.neighbourhood_members(x, -1, int(Statistic.Mean))
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_members_cuda(x, 2, 2, int(Statistic.Mean))


@pytest.mark.parametrize("fn,stat", [
    (stencil.neighbourhood_minmax_cuda, Statistic.Mean),
    (stencil.neighbourhood_var_cuda, Statistic.Max),
    (stencil.neighbourhood_mean_cuda, Statistic.Std)])
def test_wrappers_reject_other_statistics(fn, stat):
    with pytest.raises(ValueError, match="is not"):
        fn(torch.zeros(8, 8), 1, 1, int(stat))


def test_quantile_fast_wrapper_needs_the_card():
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_quantile_fast_cuda(
            torch.zeros(8, 8), 0.5, 1, 1, torch.linspace(0, 1, 4))


def test_every_kernel_source_is_built():
    """Each csrc/*.cu is one library in stencil.KERNELS, and each launch
    function named there is exported by its source."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(stencil.__file__)),
                        "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == sorted(stencil.KERNELS)
    for name, fn in stencil.KERNELS.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            assert f"int {fn}(" in f.read()
    with pytest.raises(ValueError, match="no kernel source"):
        stencil.build_kernel("neighbourhood_median")
