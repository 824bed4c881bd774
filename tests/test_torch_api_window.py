"""gridpp_tpu_torch's window API (api/window_api.py, ops/window.py) against
gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- host route (the top-level, host-pinned function), Mean/Sum/Count: both
  packages run the same native running window (csrc window_run), equal bit
  for bit;
- device route run on the CPU (`on_host` patched to False in the port's
  api.window_api; gridpp_tpu's native window switched off, which gives its
  jitted op): rtol 1e-5, atol 1e-5 (the cumsums and the stacked
  reductions run in other orders); the order statistics equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.native as jnative  # noqa: E402
import gridpp_tpu_torch.api.window_api as tapi  # noqa: E402

BAR = dict(rtol=1e-5, atol=1e-5)
FLAGS = [dict(), dict(before=True), dict(keep_missing=True),
         dict(missing_edges=False), dict(before=True, keep_missing=True,
                                         missing_edges=False)]


def _series(seed, shape=(37, 24)):
    """Hourly accumulations: gamma rain, 40% dry, 8% missing."""
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.8, 2.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.4] = 0.0
    x[rng.random(shape) < 0.08] = np.nan
    return x


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("length", [1, 3, 5])
@pytest.mark.parametrize("stat", ["Mean", "Sum", "Count"])
def test_window_host_route_bit_for_bit(stat, length, flags):
    x = _series(1)
    got = gt.window(x, length, getattr(gt, stat), **flags)
    want = gj.window(x, length, getattr(gj, stat), **flags)
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("length", [1, 3, 7])
@pytest.mark.parametrize("stat", ["Mean", "Sum", "Count", "Min", "Max",
                                  "Median", "Std", "Variance"])
def test_window_device_route_matches_jax(monkeypatch, stat, length, flags):
    x = _series(2)
    monkeypatch.setattr(jnative, "window_run", lambda *a, **k: None)
    want = gj.window(x, length, getattr(gj, stat), **flags)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    native = spy(monkeypatch, tapi.native, "window_run")
    got = tapi.window(x, length, getattr(gt, stat), **flags)
    assert not native
    assert np.array_equal(np.isnan(got), np.isnan(want))
    if stat in ("Min", "Max", "Median", "Count"):
        assert np.array_equal(got, want, equal_nan=True)
    else:
        np.testing.assert_allclose(got, want, **BAR)


@pytest.mark.parametrize("stat", ["Min", "Quantile", "Median"])
def test_window_host_order_statistics_equal(stat):
    """Statistics the native window does not take run the op on the host."""
    x = _series(3, (11, 30))
    if stat == "Quantile":
        with pytest.raises(ValueError) as ej:
            gj.window(x, 3, gj.Quantile)
        with pytest.raises(ValueError) as et:
            gt.window(x, 3, gt.Quantile)
        assert str(et.value) == str(ej.value)
        return
    got = gt.window(x, 5, getattr(gt, stat), before=True)
    want = gj.window(x, 5, getattr(gj, stat), before=True)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("args", [dict(length=0), dict(length=4),
                                  dict(shape=(3,)), dict(shape=(0, 4)),
                                  dict(shape=(4, 0))])
def test_window_edges_and_errors_match(args):
    args = dict(args)
    x = np.ones(args.pop("shape", (4, 6)), np.float32)
    length = args.pop("length", 3)
    try:
        want = gj.window(x, length, gj.Mean)
    except ValueError as e:
        with pytest.raises(ValueError) as et:
            gt.window(x, length, gt.Mean)
        assert str(et.value) == str(e)
        return
    got = gt.window(x, length, gt.Mean)
    assert got.shape == want.shape and got.dtype == want.dtype
