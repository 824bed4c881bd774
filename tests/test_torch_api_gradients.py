"""gridpp_tpu_torch's gradient API (api/gradients.py) against gridpp_tpu's
on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- simple_gradient, full_gradient and full_gradient_debug: rtol 1e-6, atol
  1e-4 (the bilinear blend's bar; nearest is a gather);
- calc_gradient LinearRegression, host route (the top-level, host-pinned
  function): both packages run the same native C++ solver, equal bit for
  bit;
- calc_gradient LinearRegression, device route run on the CPU (`on_host`
  patched to False in the port's api.gradients; gridpp_tpu's native
  solver switched off, which gives its jnp fallback): K1's bars, rtol
  1e-5, atol 1e-4 (tests/test_pallas_stencil.py:36-38), with exactly five
  windowed statistics (four Means, one Sum: five K1 launches on the card);
  on smooth relief, where the variance cancels most of f32's digits
  (ROADMAP F9), within K1's bars carried through the regression;
- calc_gradient MinMax: equal, exact ties in the window included (the first
  window position wins in both), on either route and in small chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.native as jnative  # noqa: E402
import gridpp_tpu_torch.api.gradients as tapi  # noqa: E402
from gridpp_tpu_torch.api.gradients import lr_bar  # noqa: E402

RTOL, ATOL = 1e-6, 1e-4
K1_RTOL, K1_ATOL = 1e-5, 1e-4


def _terrain(seed, shape, top=2000.0):
    """A smooth seeded elevation field of 0-top m: a sum of six random
    plane waves."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    z = np.zeros(shape)
    for _ in range(6):
        ky, kx, ph = rng.uniform(0.02, 0.16, 3)
        z += rng.uniform(0.5, 1) * np.sin(ky * yy + kx * xx + 6 * ph)
    return ((z - z.min()) / (z.max() - z.min()) * top).astype(np.float32)


def _setup(pkg, seed=0):
    """A 30 x 40 source with terrain and lafs, a 45 x 50 target past its
    edges with its own, and 60 points with elevations and lafs."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, 30), np.linspace(5, 9, 40),
                             indexing="ij")
    olats, olons = np.meshgrid(np.linspace(54.9, 58.1, 45),
                               np.linspace(4.9, 9.1, 50), indexing="ij")
    src = pkg.Grid(lats, lons, _terrain(seed, lats.shape),
                   rng.uniform(0, 1, lats.shape).astype(np.float32))
    tgt = pkg.Grid(olats, olons, _terrain(seed + 1, olats.shape),
                   rng.uniform(0, 1, olats.shape).astype(np.float32))
    pts = pkg.Points(rng.uniform(54.8, 58.2, 60), rng.uniform(4.8, 9.2, 60),
                     rng.uniform(0, 2000, 60), rng.uniform(0, 1, 60))
    return src, tgt, pts


def _fields(seed, shape, t=None):
    rng = np.random.default_rng(seed + 100)
    lead = () if t is None else (t,)
    vals = rng.normal(280, 5, lead + shape).astype(np.float32)
    vals[rng.random(vals.shape) < 0.03] = np.nan
    eg = rng.normal(-0.0065, 0.002, lead + shape).astype(np.float32)
    lg = rng.normal(1.5, 0.5, lead + shape).astype(np.float32)
    return vals, eg, lg


@pytest.mark.parametrize("downscaler", ["Nearest", "Bilinear"])
@pytest.mark.parametrize("target", ["grid", "points"])
@pytest.mark.parametrize("t", [None, 3])
def test_simple_gradient_matches(downscaler, target, t):
    out = {}
    for pkg in (gj, gt):
        src, tgt, pts = _setup(pkg)
        vals, _, _ = _fields(0, src.lats.shape, t)
        out[pkg] = pkg.simple_gradient(src, tgt if target == "grid" else pts,
                                       vals, -0.0065,
                                       getattr(pkg, downscaler))
    assert out[gt].dtype == np.float32 and out[gt].shape == out[gj].shape
    np.testing.assert_allclose(out[gt], out[gj], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("downscaler", ["Nearest", "Bilinear"])
@pytest.mark.parametrize("target", ["grid", "points"])
@pytest.mark.parametrize("case", ["2d", "3d", "elev_only", "laf_only"])
def test_full_gradient_matches(downscaler, target, case):
    """2-D values with 2-D gradient fields and 3-D values with 3-D ones,
    where the two packages agree (ROADMAP F10 covers 3-D values with a
    2-D field)."""
    out = {}
    for pkg in (gj, gt):
        src, tgt, pts = _setup(pkg, 1)
        vals, eg, lg = _fields(1, src.lats.shape, 3 if case == "3d" else None)
        if case == "elev_only":
            lg = None
        if case == "laf_only":
            eg = np.zeros(0, np.float32)
        out[pkg] = pkg.full_gradient(src, tgt if target == "grid" else pts,
                                     vals, eg, lg, getattr(pkg, downscaler))
    assert out[gt].dtype == np.float32 and out[gt].shape == out[gj].shape
    np.testing.assert_allclose(out[gt], out[gj], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unpinned", [False, True])
def test_full_gradient_2d_fields_apply_at_every_time(unpinned):
    """ROADMAP F10: with 3-D values and 2-D gradient fields, the port
    corrects every time with the one field, as gridpp_tpu's 2-D call does
    time by time; gridpp_tpu's 3-D call takes the field's second copy as
    the downscaled elevations and differs."""
    src_j, tgt_j, _ = _setup(gj, 2)
    src_t, tgt_t, _ = _setup(gt, 2)
    vals, eg, lg = _fields(2, src_t.lats.shape, 4)
    fn = tapi.full_gradient if unpinned else gt.full_gradient
    got = fn(src_t, tgt_t, vals, eg[0], lg[0], gt.Bilinear)
    want = np.stack([gj.full_gradient(src_j, tgt_j, vals[i], eg[0], lg[0],
                                      gj.Bilinear) for i in range(4)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    stacked = gj.full_gradient(src_j, tgt_j, vals, eg[0], lg[0], gj.Bilinear)
    assert not np.allclose(stacked, want, rtol=RTOL, atol=ATOL,
                           equal_nan=True)


def test_full_gradient_debug_matches():
    out = {}
    for pkg in (gj, gt):
        src, tgt, _ = _setup(pkg, 3)
        vals, eg, _ = _fields(3, src.lats.shape)
        out[pkg] = pkg.full_gradient_debug(src, tgt, vals, eg, None,
                                           pkg.Bilinear)
    assert out[gt].shape == out[gj].shape == (3, 45, 50)
    np.testing.assert_allclose(out[gt], out[gj], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["values", "elev", "laf"])
def test_full_gradient_errors_match(bad):
    def call(pkg):
        src, tgt, _ = _setup(pkg, 4)
        vals, eg, lg = _fields(4, src.lats.shape)
        if bad == "values":
            vals = vals[:, :-1]
        elif bad == "elev":
            eg = eg[:-1]
        else:
            lg = lg[:, :-2]
        return pkg.full_gradient(src, tgt, vals, eg, lg)

    with pytest.raises(ValueError) as ej:
        call(gj)
    with pytest.raises(ValueError) as et:
        call(gt)
    assert str(et.value) == str(ej.value)


def _lr_inputs(seed, shape=(60, 70), nan_frac=0.05):
    """Temperature against a smooth 0-2000 m terrain, with missing cells
    in both."""
    rng = np.random.default_rng(seed)
    base = _terrain(seed, shape)
    values = (288 - 0.0065 * base + rng.normal(0, 2, shape)).astype(
        np.float32)
    base[rng.random(shape) < nan_frac] = np.nan
    values[rng.random(shape) < nan_frac] = np.nan
    return base, values


LR_CASES = [dict(halfwidth=3), dict(halfwidth=10),
            dict(halfwidth=2, min_num=20),
            dict(halfwidth=5, min_range=40.0, default_gradient=-1.0),
            dict(halfwidth=100)]


@pytest.mark.parametrize("kw", LR_CASES)
def test_calc_gradient_lr_host_route_bit_for_bit(kw):
    base, values = _lr_inputs(5)
    got = gt.calc_gradient(base, values, gt.LinearRegression, **kw)
    want = gj.calc_gradient(base, values, gj.LinearRegression, **kw)
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("kw", LR_CASES)
def test_calc_gradient_lr_device_route_matches_jax_fallback(monkeypatch, kw):
    base, values = _lr_inputs(6)
    monkeypatch.setattr(jnative, "calc_gradient_lr", lambda *a: None)
    want = gj.calc_gradient(base, values, gj.LinearRegression, **kw)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    windows = spy(monkeypatch, tapi.nops, "neighbourhood")
    got = tapi.calc_gradient(base, values, gt.LinearRegression, **kw)
    assert len(windows) == 5
    np.testing.assert_allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL)


def test_calc_gradient_lr_routes_agree_on_decisions(monkeypatch):
    """With a missing default, a cell's gradient or its default shows which
    cells each route solved: on this terrain the f32 device route and the
    double-summing native route decide alike, where min_num and where
    min_range decide. (Their values differ by more than K1's bars where a
    small window's spread is small against its mean elevation: chip_smoke
    prints that difference on the card.)"""
    base, values = _lr_inputs(7)
    for kw in (dict(halfwidth=2, min_num=24),
               dict(halfwidth=4, min_range=60.0)):
        host = gt.calc_gradient(base, values, gt.LinearRegression,
                                default_gradient=np.nan, **kw)
        with monkeypatch.context() as m:
            m.setattr(tapi, "on_host", lambda: False)
            dev = tapi.calc_gradient(base, values, gt.LinearRegression,
                                     default_gradient=np.nan, **kw)
        assert np.isnan(host).any() and np.isfinite(host).any()
        assert np.array_equal(np.isnan(dev), np.isnan(host))


@pytest.mark.parametrize("lapse", [0.0, -0.0065])
def test_calc_gradient_lr_smooth_terrain_within_carried_bars(monkeypatch,
                                                             lapse):
    """ROADMAP F9: on smooth relief (a 2.5 km grid's, h=10) E[xx] - E[x]^2
    cancels most of f32's digits, and two f32 routes that sum their
    moments in other orders (the port's device route on the CPU, gridpp_
    tpu's jnp fallback) may differ past K1's bars on the gradient itself.
    Every cell whose variance K1's bars determine stays within those bars
    carried through the regression (api/gradients.lr_bar), on noise alone
    and on noise about a lapse rate."""
    rng = np.random.default_rng(12)
    shape = (240, 200)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    z = sum(np.sin(rng.uniform(0.005, 0.05) * yy
                   + rng.uniform(0.005, 0.05) * xx + rng.uniform(0, 6))
            for _ in range(6))
    base = ((z - z.min()) / (z.max() - z.min()) * 2000).astype(np.float32)
    values = (rng.normal(280, 5, shape) + lapse * base).astype(np.float32)
    monkeypatch.setattr(jnative, "calc_gradient_lr", lambda *a: None)
    want = gj.calc_gradient(base, values, gj.LinearRegression, 10)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    got = tapi.calc_gradient(base, values, gt.LinearRegression, 10)
    bar, det = lr_bar([m.numpy() for m in tapi.lr_moments(
        torch.from_numpy(base), torch.from_numpy(values), 10)],
        K1_RTOL, K1_ATOL)
    d = np.abs(got - want)
    assert det.mean() > 0.99
    assert (d <= bar + K1_ATOL + K1_RTOL * np.abs(want))[det].all()


def _tied_inputs(seed, shape=(40, 50)):
    """Integer elevations in a narrow range (many exact ties of the
    window's maximum and minimum) and distinct values, so a tie picks a
    different answer at each position."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, shape).astype(np.float32) * 100
    values = rng.normal(280, 5, shape).astype(np.float32)
    base[rng.random(shape) < 0.05] = np.nan
    return base, values


@pytest.mark.parametrize("unpinned", [False, True])
@pytest.mark.parametrize("kw", [dict(halfwidth=1), dict(halfwidth=3),
                                dict(halfwidth=2, min_num=10),
                                dict(halfwidth=2, min_range=150.0,
                                     default_gradient=-7.0)])
def test_calc_gradient_minmax_equal_with_ties(monkeypatch, kw, unpinned):
    base, values = _tied_inputs(8)
    want = gj.calc_gradient(base, values, gj.MinMax, **kw)
    if unpinned:
        monkeypatch.setattr(tapi, "on_host", lambda: False)
    fn = tapi.calc_gradient if unpinned else gt.calc_gradient
    got = fn(base, values, gt.MinMax, **kw)
    assert np.array_equal(got, want, equal_nan=True)
    # the ties do decide: the last maximal position would give another
    # answer somewhere
    flipped = gj.calc_gradient(base[::-1, ::-1], values[::-1, ::-1],
                               gj.MinMax, **kw)[::-1, ::-1]
    assert not np.array_equal(flipped, want, equal_nan=True)


def test_calc_gradient_minmax_chunks(monkeypatch):
    base, values = _tied_inputs(9, (37, 41))
    whole = gt.calc_gradient(base, values, gt.MinMax, 3)
    monkeypatch.setattr(tapi, "_MINMAX_CHUNK", 41 * 49 * 4)  # 4 rows
    assert np.array_equal(gt.calc_gradient(base, values, gt.MinMax, 3),
                          whole, equal_nan=True)


@pytest.mark.parametrize("args", [
    dict(halfwidth=0), dict(halfwidth=2, min_range=-1.0),
    dict(halfwidth=2, min_num=-1), dict(halfwidth=2, shape=(0, 0)),
    dict(halfwidth=2, mismatch=True), dict(halfwidth=2, gradient_type=9)])
def test_calc_gradient_errors_match(args):
    args = dict(args)
    shape = args.pop("shape", (5, 6))
    mismatch = args.pop("mismatch", False)
    gtype = args.pop("gradient_type", int(gt.LinearRegression))
    base = np.ones(shape, np.float32)
    values = np.ones((5, 7) if mismatch else shape, np.float32)
    with pytest.raises(ValueError) as ej:
        gj.calc_gradient(base, values, gtype, **args)
    with pytest.raises(ValueError) as et:
        gt.calc_gradient(base, values, gtype, **args)
    assert str(et.value) == str(ej.value)
