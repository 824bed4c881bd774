"""gridpp_tpu_torch's meteorological diagnostics (api/diagnostics.py,
ops/diagnostics.py) against gridpp_tpu's on the CPU.

The same seeded numpy inputs, scalars and vectors, go through both
packages. Bars: rtol 1e-5, atol 1e-5 (tests/test_host_device_parity.py's:
XLA and torch differ in the last ulps of exp, log and pow); pressure and
sea_level_pressure, in Pa (~1e5), atol 1e-2 Pa; gamma_inv (scipy on the
host in both) equal bit for bit; the validation errors alike.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_helpers import gj, gt  # noqa: E402
import gridpp_tpu_torch.api.diagnostics as tapi  # noqa: E402

BAR = dict(rtol=1e-5, atol=1e-5)
PA_BAR = dict(rtol=1e-5, atol=1e-2)
N = 5000


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(230, 315, N).astype(np.float32)
    rh = rng.uniform(0.01, 1.0, N).astype(np.float32)
    td = (t - rng.uniform(0, 25, N)).astype(np.float32)
    p = rng.uniform(50000, 105000, N).astype(np.float32)
    z0 = rng.uniform(-20, 2500, N).astype(np.float32)
    z1 = rng.uniform(-20, 2500, N).astype(np.float32)
    u = rng.normal(0, 8, N).astype(np.float32)
    v = rng.normal(0, 8, N).astype(np.float32)
    for a in (t, rh, td, u):
        a[rng.random(N) < 0.02] = np.nan
    u[:4] = [0, 0, 1, -1]
    v[:4] = [0, 1, 0, 0]
    return dict(t=t, rh=rh, td=td, p=p, z0=z0, z1=z1, u=u, v=v)


CALLS = {
    "dewpoint": (("t", "rh"), BAR),
    "relative_humidity": (("t", "td"), BAR),
    "wetbulb": (("t", "p", "rh"), BAR),
    "pressure": (("z0", "z1", "p", "t"), PA_BAR),
    "qnh": (("p", "z0"), PA_BAR),
    "wind_speed": (("u", "v"), BAR),
    "wind_direction": (("u", "v"), BAR),
}


@pytest.mark.parametrize("unpinned", [False, True])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_diagnostic_matches_jax(name, unpinned):
    keys, bar = CALLS[name]
    x = _inputs(1)
    args = [x[k] for k in keys]
    fn = getattr(tapi, name) if unpinned else getattr(gt, name)
    got = fn(*args)
    want = getattr(gj, name)(*args)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **bar)
    # a scalar call gives a float, as gridpp's scalar overloads do
    one = fn(*[float(a[7]) for a in args])
    assert isinstance(one, float)
    np.testing.assert_allclose(one, float(want[7]), **bar)


@pytest.mark.parametrize("humidity", ["rh", "td", "none"])
def test_sea_level_pressure_matches_jax(humidity):
    x = _inputs(2)
    ok = np.isfinite(x["t"])
    ps, alt, t = x["p"][ok], x["z0"][ok] + 30, x["t"][ok]
    missing = np.full(ps.shape, np.nan, np.float32)
    kw = dict(rh=missing, dewpoint=missing)
    if humidity == "rh":
        kw["rh"] = np.nan_to_num(x["rh"][ok], nan=0.5)
    elif humidity == "td":
        kw["dewpoint"] = np.nan_to_num(x["td"][ok], nan=270.0)
    got = gt.sea_level_pressure(ps, alt, t, **kw)
    want = gj.sea_level_pressure(ps, alt, t, **kw)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **PA_BAR)
    assert isinstance(gt.sea_level_pressure(101000.0, 10.0, 280.0), float)
    np.testing.assert_allclose(gt.sea_level_pressure(95000.0, 600.0, 275.0),
                               gj.sea_level_pressure(95000.0, 600.0, 275.0),
                               **PA_BAR)


def test_gamma_inv_bit_for_bit():
    rng = np.random.default_rng(3)
    levels = rng.uniform(0, 1, 70000).astype(np.float32)
    shape = rng.uniform(0.2, 5, 70000).astype(np.float32)
    scale = rng.uniform(0.5, 3, 70000).astype(np.float32)
    assert np.array_equal(gt.gamma_inv(levels, shape, scale),
                          gj.gamma_inv(levels, shape, scale))
    assert np.array_equal(tapi.gamma_inv(levels[:9], shape[:9], scale[:9]),
                          gj.gamma_inv(levels[:9], shape[:9], scale[:9]))


@pytest.mark.parametrize("call", [
    lambda m: m.dewpoint([280.0, 281.0], [0.5]),
    lambda m: m.relative_humidity([280.0], [270.0, 271.0]),
    lambda m: m.wetbulb([280.0, 281.0], [1e5], [0.5, 0.5]),
    lambda m: m.wetbulb([280.0, 281.0], [1e5, 1e5], [0.5]),
    lambda m: m.qnh([1e5, 1e5], [10.0]),
    lambda m: m.wind_speed([1.0, 2.0], [1.0]),
    lambda m: m.wind_direction([1.0], [1.0, 2.0]),
    lambda m: m.pressure([1.0, 2.0], [1.0], [1e5, 1e5], [280.0, 280.0]),
    lambda m: m.sea_level_pressure([1e5, 1e5], [10.0], [280.0, 280.0]),
    lambda m: m.sea_level_pressure(1e5, np.nan, 280.0),
    lambda m: m.sea_level_pressure(1e5, 10.0, np.nan),
    lambda m: m.sea_level_pressure(-1.0, 10.0, 280.0),
    lambda m: m.sea_level_pressure(1e5, 10.0, 280.0, rh=1.5),
    lambda m: m.gamma_inv([1.5], [1.0], [1.0]),
    lambda m: m.gamma_inv([0.5], [0.0], [1.0]),
    lambda m: m.gamma_inv([0.5], [1.0], [-1.0])])
def test_diagnostic_errors_match(call):
    with pytest.raises((ValueError, RuntimeError)) as ej:
        call(gj)
    with pytest.raises((ValueError, RuntimeError)) as et:
        call(gt)
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)
