"""gridpp_tpu_torch's ensemble OI numpy API (api/oi_ensi.py,
api/oi_ensi_multi.py) against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- host route (the top-level, host-pinned functions): both packages run the
  same native C++ solvers (oi_ensi_host_solve, oi_member_host_solve,
  oi_utem_host_solve) on the same inputs, so the outputs are equal bit for
  bit (np.array_equal, NaN equal), Grid and Points forms, with and without
  extrapolation;
- host route with the native solvers switched off in both packages: the
  port's torch kernels against gridpp_tpu's XLA ones at the bars of
  tests/test_optimal_interpolation_ensi.py:144-160 and
  tests/test_oi_ensi_multi.py:424-471 (atol 5e-4, rtol 1e-4 on > 99% of
  the cells, max relative 5e-3);
- device route run on the CPU (`on_host` patched to False in both
  packages' api modules; nothing in gridpp_tpu changes): EnSI's shortlist,
  dense and host-candidate paths within rtol 2e-4 / atol 2e-3 of
  gridpp_tpu's same path, ebe/ebesc within atol 2e-4 and utem 5e-4 (rtol
  1e-4) of theirs (PERF.md §2); the shortlist routes equal the port's
  EnsiPipeline and MultiEnsiPipeline bit for bit;
- ROADMAP F4 for EnSI: the chunked native solve fed by the canonical
  shortlist equals the ball-query-fed one bit for bit;
- the reference's behavioural cases and invalid-argument sweeps
  (tests/test_optimal_interpolation_ensi.py:9-124,
  tests/test_oi_ensi_multi.py:26-300) against the port's namespace, on
  the host route and on the device route.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.api._common as jcommon  # noqa: E402
import gridpp_tpu.api.oi as japi  # noqa: E402
import gridpp_tpu.api.oi_ensi as jensi  # noqa: E402
import gridpp_tpu.api.oi_ensi_multi as jmulti  # noqa: E402
import gridpp_tpu_torch.api.oi as tapi  # noqa: E402
import gridpp_tpu_torch.api.oi_ensi as tensi  # noqa: E402
import gridpp_tpu_torch.api.oi_ensi_multi as tmulti  # noqa: E402

ENSI_TOL = dict(rtol=2e-4, atol=2e-3)  # PERF.md §2
MULTI_TOL = {"ebe": dict(rtol=1e-4, atol=2e-4),
             "ebesc": dict(rtol=1e-4, atol=2e-4),
             "utem": dict(rtol=1e-4, atol=5e-4)}
VARIANTS = ("ebe", "ebesc", "utem")


def _ensi_net(seed=0, ny=30, nx=36, p=120, e=6, nan_every=13):
    """tests/test_optimal_interpolation_ensi.py:129-142."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, ny), np.linspace(5, 8, nx),
                             indexing="ij")
    d = dict(lats=lats, lons=lons, plats=rng.uniform(55.05, 57.95, p),
             plons=rng.uniform(5.05, 7.95, p))
    bg = rng.normal(280, 5, (ny, nx, e)).astype(np.float32)
    nn = gt.Grid(lats, lons).nearest_map(d["plats"], d["plons"])
    pback = bg.reshape(-1, e)[nn]
    pobs = (pback.mean(axis=1) + rng.normal(0, 1, p)).astype(np.float32)
    pobs[::nan_every] = np.nan
    d.update(bg=bg, pback=pback, pobs=pobs,
             sig=np.full(p, 1.2, np.float32))
    return d


def _multi_net(seed=0, ny=24, nx=30, p=90, e=5, nan_every=11):
    """tests/test_oi_ensi_multi.py:404-422."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 57.5, ny),
                             np.linspace(5, 7.5, nx), indexing="ij")
    d = dict(lats=lats, lons=lons, plats=rng.uniform(55.05, 57.45, p),
             plons=rng.uniform(5.05, 7.45, p))
    bg = rng.normal(280, 5, (ny, nx, e)).astype(np.float32)
    bgc = (bg + rng.normal(0, 1, (ny, nx, e))).astype(np.float32)
    nn = gt.Grid(lats, lons).nearest_map(d["plats"], d["plons"])
    pobs_e = (bg.reshape(-1, e)[nn] + rng.normal(0, 1, (p, e))).astype(
        np.float32)
    pobs_e[::nan_every] = np.nan
    d.update(bg=bg, bgc=bgc, pback=bg.reshape(-1, e)[nn],
             pbackc=bgc.reshape(-1, e)[nn], pobs_e=pobs_e,
             ratios=np.full(p, 0.1, np.float32),
             bratios=np.ones((ny, nx), np.float32))
    return d


def _objs(pkg, d, form="grid"):
    """(background object, obs Points) of package pkg."""
    if form == "grid":
        b = pkg.Grid(d["lats"], d["lons"])
    else:
        b = pkg.Points(d["lats"].ravel(), d["lons"].ravel())
    return b, pkg.Points(d["plats"], d["plons"])


def _flat(a, form):
    """A (Y, X[, E]) field in the Grid or the Points form."""
    return a if form == "grid" else a.reshape((-1,) + a.shape[2:])


def _ensi(pkg_or_mod, d, structure, form="grid", max_points=8,
          allow=True, pkg=None):
    b, pts = _objs(pkg or pkg_or_mod, d, form)
    return pkg_or_mod.optimal_interpolation_ensi(
        b, _flat(d["bg"], form), pts, d["pobs"], d["sig"], d["pback"],
        structure, max_points, allow)


def _multi(fn_owner, variant, d, structure, form="grid", max_points=8,
           allow=True, pkg=None):
    """optimal_interpolation_ensi_multi_<variant> of fn_owner (a package or
    an api module; pkg builds the objects)."""
    b, pts = _objs(pkg or fn_owner, d, form)
    fn = getattr(fn_owner, f"optimal_interpolation_ensi_multi_{variant}")
    br, bg = _flat(d["bratios"], form), _flat(d["bg"], form)
    if variant == "ebesc":
        return fn(b, br, bg, pts, d["pobs_e"], d["ratios"], d["pback"],
                  structure, max_points, allow)
    pobs = d["pobs_e"][:, 0].copy() if variant == "utem" else d["pobs_e"]
    return fn(b, br, bg, _flat(d["bgc"], form), pts, pobs, d["ratios"],
              d["pback"], d["pbackc"], structure, max_points, allow)


@pytest.fixture
def device_route(monkeypatch):
    """Both packages' API takes its device route on the CPU."""
    for mod in (japi, jensi, jmulti, jcommon, tapi, tensi, tmulti):
        monkeypatch.setattr(mod, "on_host", lambda: False)


@pytest.fixture
def no_native(monkeypatch):
    """The native solvers switched off in both packages."""
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "_native_kernel_type", lambda s: None)


def _assert_close(got, want, **tol):
    """tests/test_oi_ensi_multi.py:424-428."""
    close = np.isclose(got, want, equal_nan=True, **tol)
    assert close.mean() > 0.99, f"{(~close).sum()} mismatches"
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert np.nanmax(rel) < 5e-3


STRUCTURES = {
    "barnes": lambda pkg: pkg.BarnesStructure(25000.0),
    "cressman": lambda pkg: pkg.CressmanStructure(40000.0),
    "soar": lambda pkg: pkg.SoarStructure(20000.0),
    "powerlaw": lambda pkg: pkg.PowerlawStructure(15000.0),
}


# -- host route ------------------------------------------------------------

@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("form", ["grid", "points"])
@pytest.mark.parametrize("name", list(STRUCTURES))
def test_ensi_host_route_bit_for_bit(name, form, allow):
    d = _ensi_net(seed=len(name) + allow)
    out = [_ensi(pkg, d, STRUCTURES[name](pkg), form, allow=allow)
           for pkg in (gj, gt)]
    assert out[0].shape == out[1].shape == _flat(d["bg"], form).shape
    assert np.array_equal(out[0], out[1], equal_nan=True)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("form", ["grid", "points"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_multi_host_route_bit_for_bit(variant, form, allow):
    d = _multi_net(seed=VARIANTS.index(variant) + 2 * allow)
    out = [_multi(pkg, variant, d, pkg.BarnesStructure(40000.0), form,
                  allow=allow) for pkg in (gj, gt)]
    assert out[0].shape == out[1].shape == _flat(d["bg"], form).shape
    assert np.array_equal(out[0], out[1], equal_nan=True)
    assert not np.array_equal(out[1], _flat(d["bg"], form))


@pytest.mark.parametrize("allow", [True, False])
def test_ensi_torch_kernel_matches_xla(allow, no_native, monkeypatch):
    """tests/test_optimal_interpolation_ensi.py:144-160."""
    calls = spy(monkeypatch, tensi, "ensi_kernel")
    d = _ensi_net(seed=int(allow))
    out = [_ensi(pkg, d, pkg.BarnesStructure(25000.0), allow=allow)
           for pkg in (gj, gt)]
    assert calls
    _assert_close(out[1], out[0], atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_multi_torch_kernels_match_xla(variant, allow, no_native,
                                       monkeypatch):
    """tests/test_oi_ensi_multi.py:430-471."""
    calls = spy(monkeypatch, tmulti, f"{variant}_kernel")
    d = _multi_net(seed=2 * VARIANTS.index(variant) + int(allow))
    out = [_multi(pkg, variant, d, pkg.BarnesStructure(40000.0),
                  allow=allow) for pkg in (gj, gt)]
    assert calls
    _assert_close(out[1], out[0], atol=5e-4, rtol=1e-4)


def test_ensi_chunked_shortlist_feed_equals_ball_feed(monkeypatch):
    """ROADMAP F4 for EnSI: the chunked host path (forced at a small
    size) fed by the canonical shortlist equals the ball-query-fed one bit
    for bit (uniform obs elevations: monotone_obs holds)."""
    monkeypatch.setattr(tensi, "_BALL_QUERY_MAX", 400)
    monkeypatch.setattr(tensi, "_BLOCK", 384)
    feeds = []
    real = tapi._chunked_shortlist

    def record(*a, **k):
        feeds.append(real(*a, **k))
        return feeds[-1]

    monkeypatch.setattr(tapi, "_chunked_shortlist", record)
    d = _ensi_net(seed=7)
    s = gt.BarnesStructure(25000.0)
    sl_fed = _ensi(gt, d, s)
    assert feeds and feeds[0] is not None
    monkeypatch.setattr(tapi, "_chunked_shortlist", lambda *a, **k: None)
    ball_fed = _ensi(gt, d, s)
    assert np.array_equal(sl_fed, ball_fed, equal_nan=True)
    assert not np.array_equal(sl_fed, d["bg"])


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_ensi_conditioning_guard(device, monkeypatch, capsys):
    """Zero sigmas blow up Rinv: the raw background comes back and a
    warning is printed (oi_ensi.cpp:557-566), on either route."""
    if device:
        monkeypatch.setattr(tensi, "on_host", lambda: False)
    d = _ensi_net(seed=3)
    d["sig"] = np.zeros_like(d["sig"])
    out = _ensi(tensi if device else gt, d, gt.BarnesStructure(25000.0),
                pkg=gt)
    np.testing.assert_array_equal(out, d["bg"])
    assert "Condition number error" in capsys.readouterr().out


# -- device route, run on the CPU --------------------------------------------

def test_ensi_device_shortlist_route(device_route, monkeypatch):
    calls = spy(monkeypatch, tensi, "_ensi_shortlist")
    kern = spy(monkeypatch, tensi, "ensi_kernel")
    d = _ensi_net(seed=4)
    out = [_ensi(pkg, d, pkg.BarnesStructure(25000.0)) for pkg in (gj, gt)]
    assert calls and not kern
    np.testing.assert_allclose(out[1], out[0], **ENSI_TOL)
    # the EnsiPipeline's cycle on the same shortlist
    b, pts = _objs(gt, d)
    s = gt.BarnesStructure(25000.0)
    api = _ensi(tensi, d, s, pkg=gt)
    pipe = gt.EnsiPipeline(b, pts, s, halfwidth=0, max_points=8,
                           device="cpu")
    want, n_cond = pipe.run_device(torch.as_tensor(d["bg"]),
                                   torch.as_tensor(d["pobs"]),
                                   torch.as_tensor(d["sig"]))
    assert int(n_cond) == 0
    assert np.array_equal(api, want.numpy())


def _dense_ens_net(seed=5, n=6000, p=1500, e=4):
    """Cartesian points over 100 km x 100 km, an ensemble with spread at
    the obs and half of a dense network missing: truncated rows starve and
    n x (valid obs) > 4e6, so the device route takes the dense sweep."""
    rng = np.random.default_rng(seed)
    d = dict(y=rng.uniform(0, 1e5, n), x=rng.uniform(0, 1e5, n),
             py=rng.uniform(0, 1e5, p), px=rng.uniform(0, 1e5, p))
    d["bg"] = rng.normal(0, 1, (n, e)).astype(np.float32)
    d["pback"] = rng.normal(0, 1, (p, e)).astype(np.float32)
    d["pobs"] = (d["pback"].mean(axis=1) + rng.normal(0, 0.5, p)).astype(
        np.float32)
    d["pobs"][rng.random(p) < 0.5] = np.nan
    d["sig"] = np.full(p, 0.7, np.float32)
    return d


def test_ensi_device_dense_route(device_route, monkeypatch):
    # gridpp_tpu pads the dense sweep to whole blocks: keep them small here
    monkeypatch.setattr(jensi, "_BLOCK", 8192)
    dense = spy(monkeypatch, tensi, "ensi_dense_sweep")
    d = _dense_ens_net()
    assert np.isfinite(d["pobs"]).sum() * d["bg"].shape[0] > 4_000_000
    out = []
    for pkg in (gj, gt):
        b = pkg.Points(d["y"], d["x"], type=pkg.Cartesian)
        pts = pkg.Points(d["py"], d["px"], type=pkg.Cartesian)
        out.append(pkg.optimal_interpolation_ensi(
            b, d["bg"], pts, d["pobs"], d["sig"], d["pback"],
            pkg.BarnesStructure(5000.0, 0.0), 10))
    assert dense
    np.testing.assert_allclose(out[1], out[0], **ENSI_TOL)
    assert np.abs(out[1] - d["bg"]).max() > 0.1


def test_ensi_device_host_candidate_route(device_route, monkeypatch):
    """A starved shortlist row on a network too small for the dense sweep:
    ensi_kernel on host-fed candidates, on the device."""
    kern = spy(monkeypatch, tensi, "ensi_kernel")
    d = _ensi_net(seed=6, nan_every=2)
    d["pobs"][1::3] = np.nan
    out = [_ensi(pkg, d, pkg.BarnesStructure(25000.0)) for pkg in (gj, gt)]
    assert kern
    np.testing.assert_allclose(out[1], out[0], **ENSI_TOL)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_multi_device_shortlist_route(variant, allow, device_route,
                                      monkeypatch):
    kern = spy(monkeypatch, tmulti, f"{variant}_kernel")
    d = _multi_net(seed=10 + VARIANTS.index(variant) + 3 * allow)
    out = [_multi(pkg, variant, d, pkg.BarnesStructure(40000.0),
                  allow=allow) for pkg in (gj, gt)]
    assert not kern
    np.testing.assert_allclose(out[1], out[0], **MULTI_TOL[variant])
    # the MultiEnsiPipeline's cycle on the same shortlist
    b, pts = _objs(gt, d)
    s = gt.BarnesStructure(40000.0)
    api = _multi(tmulti, variant, d, s, allow=allow, pkg=gt)
    pipe = gt.MultiEnsiPipeline(b, pts, s, variant=variant, max_points=8,
                                allow_extrapolation=allow,
                                bratios=d["bratios"], device="cpu")
    pobs = d["pobs_e"][:, 0].copy() if variant == "utem" else d["pobs_e"]
    want, _ = pipe.run_device(
        torch.as_tensor(d["bg"]), torch.as_tensor(pobs),
        torch.as_tensor(d["ratios"]),
        None if variant == "ebesc" else torch.as_tensor(d["bgc"]))
    assert np.array_equal(api, want.numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_multi_device_host_candidate_route(variant, device_route,
                                           monkeypatch):
    """A starved shortlist row: the host-candidate kernels on the device
    (ensi_multi has no dense sweep)."""
    kern = spy(monkeypatch, tmulti, f"{variant}_kernel")
    d = _multi_net(seed=20 + VARIANTS.index(variant), nan_every=2)
    d["pobs_e"][1::3] = np.nan
    out = [_multi(pkg, variant, d, pkg.BarnesStructure(40000.0))
           for pkg in (gj, gt)]
    assert kern
    np.testing.assert_allclose(out[1], out[0], **MULTI_TOL[variant])


# -- the reference's behavioural cases, on the port's namespace ---------------

@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    """The port's top level (host route), or its api modules with the
    device route taken on the CPU: a namespace holding the six
    functions."""
    if request.param == "host":
        return gt
    for mod in (tapi, tensi, tmulti):
        monkeypatch.setattr(mod, "on_host", lambda: False)
    ns = collections.namedtuple("ns", "optimal_interpolation "
                                      "optimal_interpolation_ensi "
                                      "optimal_interpolation_ensi_multi_ebe "
                                      "optimal_interpolation_ensi_multi_ebesc "
                                      "optimal_interpolation_ensi_multi_utem")
    return ns(tapi.optimal_interpolation, tensi.optimal_interpolation_ensi,
              tmulti.optimal_interpolation_ensi_multi_ebe,
              tmulti.optimal_interpolation_ensi_multi_ebesc,
              tmulti.optimal_interpolation_ensi_multi_utem)


# tests/test_optimal_interpolation_ensi.py:9-124

def test_ensi_no_obs(route):
    out = route.optimal_interpolation_ensi(
        gt.Points([0], [0]), np.zeros([1, 3]), gt.Points([], []), [], [],
        np.zeros([0, 3]), gt.BarnesStructure(500000), 10)
    np.testing.assert_almost_equal(out, np.zeros([1, 3]))


def test_ensi_some_missing_obs(route):
    out = route.optimal_interpolation_ensi(
        gt.Points([0], [0]), np.zeros([1, 3]), gt.Points([0, 0.1], [0, 0.1]),
        [np.nan, 0], [1, 1], np.zeros([2, 3]), gt.BarnesStructure(500000),
        10)
    np.testing.assert_almost_equal(out, np.zeros([1, 3]))


def _line(n):
    y = np.arange(n) * 1000.0
    return gt.Points(y, np.zeros(n), np.zeros(n), np.zeros(n), gt.Cartesian)


def test_ensi_zero_spread_no_update(route):
    rng = np.random.default_rng(0)
    background = np.zeros((5, 4), np.float32)
    background += rng.normal(0, 0.1, (1, 4)).astype(np.float32)
    out = route.optimal_interpolation_ensi(
        _line(5), background, gt.Points([2000.0], [0], [0], [0],
                                        gt.Cartesian),
        [1.0], [0.5], np.full((1, 4), 0.3, np.float32),
        gt.BarnesStructure(1000), 10)
    np.testing.assert_allclose(out, background, atol=1e-5)


def test_ensi_mean_update(route):
    rng = np.random.default_rng(0)
    background = rng.normal(0, 1, (9, 8)).astype(np.float32)
    out = route.optimal_interpolation_ensi(
        _line(9), background, gt.Points([2000.0], [0], [0], [0],
                                        gt.Cartesian),
        np.array([5.0]), [0.5], background[[2]], gt.BarnesStructure(1000),
        10)
    assert np.mean(out[2]) > np.mean(background[2])
    assert np.std(out[2]) < np.std(background[2])
    np.testing.assert_allclose(out[8], background[8], atol=1e-4)


def test_ensi_grid_form(route):
    rng = np.random.default_rng(1)
    y, x = np.meshgrid(np.arange(0, 5000, 1000), np.arange(0, 5000, 1000),
                       indexing="ij")
    grid = gt.Grid(y, x, np.zeros(y.shape), np.zeros(y.shape), gt.Cartesian)
    background = rng.normal(0, 1, (5, 5, 3)).astype(np.float32)
    out = route.optimal_interpolation_ensi(
        grid, background, gt.Points([2000.0], [2000.0], [0], [0],
                                    gt.Cartesian),
        [2.0], [0.5], rng.normal(0, 1, (1, 3)).astype(np.float32),
        gt.BarnesStructure(1500), 10)
    assert out.shape == (5, 5, 3)
    assert np.isfinite(out).all()


def test_ensi_invalid_member_passthrough(route):
    rng = np.random.default_rng(3)
    background = rng.normal(1, 0.5, (2, 4)).astype(np.float32)
    background[0, 1] = np.nan
    pbackground = np.where(np.isfinite(background[[0]]), background[[0]],
                           1.0)
    out = route.optimal_interpolation_ensi(
        _line(2), background, gt.Points([0.0], [0], [0], [0], gt.Cartesian),
        [5.0], [0.5], pbackground, gt.BarnesStructure(1000), 10)
    assert np.isnan(out[0, 1])
    assert out[1, 1] == background[1, 1]
    valid = [0, 2, 3]
    assert np.mean(out[0, valid]) > np.mean(background[0, valid])


@pytest.mark.parametrize("n_grid,max_points", [(1, -1), (2, 10)])
def test_ensi_invalid_args(route, n_grid, max_points):
    with pytest.raises(ValueError):
        route.optimal_interpolation_ensi(
            gt.Points([0], [0]), np.zeros([n_grid, 3]),
            gt.Points([0], [0]), [1], [1], np.zeros([1, 3]),
            gt.BarnesStructure(1000), max_points)


# tests/test_oi_ensi_multi.py:26-160

def _setup(n=7, e=6, seed=0):
    rng = np.random.default_rng(seed)
    background = rng.normal(0, 1, (n, e)).astype(np.float32)
    bg_corr = background + rng.normal(0, 0.3, (n, e)).astype(np.float32)
    return dict(
        bpoints=_line(n),
        points=gt.Points([2000.0, 4000.0], [0, 0], [0, 0], [0, 0],
                         gt.Cartesian),
        structure=gt.BarnesStructure(1500.0), background=background,
        bg_corr=bg_corr, bratios=np.ones(n, np.float32),
        pback=np.stack([background[2], background[4]]).astype(np.float32),
        pback_corr=np.stack([bg_corr[2], bg_corr[4]]).astype(np.float32),
        pratios=np.full(2, 0.1, np.float32))


def test_ebe_updates_toward_obs(route):
    s = _setup()
    out = route.optimal_interpolation_ensi_multi_ebe(
        s["bpoints"], s["bratios"], s["background"], s["bg_corr"],
        s["points"], s["pback"] + 2.0, s["pratios"], s["pback"],
        s["pback_corr"], s["structure"], 10)
    assert out.shape == s["background"].shape
    assert np.mean(out[2] - s["background"][2]) > 0
    assert np.isfinite(out).all()


@pytest.mark.parametrize("variant", ["ebe", "utem"])
def test_multi_no_obs(route, variant):
    s = _setup()
    empty = gt.Points([], [], type=gt.Cartesian)
    fn = getattr(route, f"optimal_interpolation_ensi_multi_{variant}")
    pobs = np.zeros((0, 6)) if variant == "ebe" else np.zeros(0)
    out = fn(s["bpoints"], s["bratios"], s["background"], s["bg_corr"],
             empty, pobs, np.zeros(0), np.zeros((0, 6)), np.zeros((0, 6)),
             s["structure"], 10)
    np.testing.assert_array_equal(out, s["background"])


@pytest.mark.parametrize("case", ["obs_rows", "bratios"])
def test_ebe_invalid_args(route, case):
    s = _setup()
    pobs = np.zeros((3, 6)) if case == "obs_rows" else s["pback"]
    br = s["bratios"][:-1] if case == "bratios" else s["bratios"]
    with pytest.raises(ValueError):
        route.optimal_interpolation_ensi_multi_ebe(
            s["bpoints"], br, s["background"], s["bg_corr"], s["points"],
            pobs, s["pratios"], s["pback"], s["pback_corr"],
            s["structure"], 10)


def test_ebesc_updates_toward_obs(route):
    s = _setup()
    out = route.optimal_interpolation_ensi_multi_ebesc(
        s["bpoints"], s["bratios"], s["background"], s["points"],
        s["pback"] + 1.0, s["pratios"], s["pback"], s["structure"], 10)
    assert out.shape == s["background"].shape
    assert np.mean(out[2] - s["background"][2]) > 0


def test_ebesc_matches_oi_per_member(route):
    s = _setup()
    pobs = s["pback"] + np.array([[1.0], [2.0]], np.float32)
    out = route.optimal_interpolation_ensi_multi_ebesc(
        s["bpoints"], s["bratios"], s["background"], s["points"], pobs,
        s["pratios"], s["pback"], s["structure"], 10)
    for e in range(s["background"].shape[1]):
        det = route.optimal_interpolation(
            s["bpoints"], s["background"][:, e], s["points"], pobs[:, e],
            s["pratios"], s["pback"][:, e], s["structure"], 10)
        np.testing.assert_allclose(out[:, e], det, atol=1e-4)


def test_utem_conditioning_guard(route, capsys):
    s = _setup()
    out = route.optimal_interpolation_ensi_multi_utem(
        s["bpoints"], s["bratios"], s["background"], s["bg_corr"],
        s["points"], np.array([2.0, 1.0], np.float32),
        np.zeros(2, np.float32), s["pback"], s["pback_corr"],
        s["structure"], 10)
    np.testing.assert_array_equal(out, s["background"])
    assert "Condition number error" in capsys.readouterr().out


def test_anti_extrapolation_bounds_members(route):
    s = _setup()
    pobs = s["pback"] + 2.0
    args = (s["bpoints"], s["bratios"], s["background"], s["bg_corr"],
            s["points"], pobs, s["pratios"], s["pback"], s["pback_corr"],
            s["structure"], 10)
    free = route.optimal_interpolation_ensi_multi_ebe(*args, True)
    clamped = route.optimal_interpolation_ensi_multi_ebe(*args, False)
    assert free.shape == clamped.shape
    assert np.nanmax(clamped - s["background"]) <= np.nanmax(
        pobs - s["pback"]) + 1e-4


def test_member_screening_nan_background(route):
    s = _setup()
    background = s["background"].copy()
    background[3, 1] = np.nan
    pback2 = np.stack([background[2], background[4]]).astype(np.float32)
    pobs = np.where(np.isfinite(pback2), pback2 + 2.0, 2.0)
    out = route.optimal_interpolation_ensi_multi_ebe(
        s["bpoints"], s["bratios"], background, s["bg_corr"], s["points"],
        pobs, s["pratios"], pback2, s["pback_corr"], s["structure"], 10)
    np.testing.assert_array_equal(out[:, 1], background[:, 1])
    assert np.mean(out[2, [0, 2, 3, 4, 5]]
                   - background[2, [0, 2, 3, 4, 5]]) > 0


def test_utem_runs_and_updates(route):
    s = _setup()
    out = route.optimal_interpolation_ensi_multi_utem(
        s["bpoints"], s["bratios"], s["background"], s["bg_corr"],
        s["points"], np.array([2.0, 1.0], np.float32), s["pratios"],
        s["pback"], s["pback_corr"], s["structure"], 10)
    assert out.shape == s["background"].shape
    assert np.isfinite(out).all()
    assert not np.allclose(out[2], s["background"][2])


# tests/test_oi_ensi_multi.py:164-300: every malformed input raises
# ValueError, grid and points forms

E = 4


def _sweep_ok(grid_form, variant):
    if grid_form:
        lats, lons = np.meshgrid([0.0, 1000.0, 2000.0], [0.0, 1000.0],
                                 indexing="ij")
        bgrid = gt.Grid(lats, lons, np.zeros((3, 2)), np.zeros((3, 2)),
                        gt.Cartesian)
        shape = (3, 2)
    else:
        bgrid = gt.Points([0.0, 1000.0, 2000.0], [0, 0, 0], [0, 0, 0],
                          [0, 0, 0], gt.Cartesian)
        shape = (3,)
    ok = collections.OrderedDict(
        bgrid=bgrid, bratios=np.ones(shape, np.float32),
        background=np.zeros(shape + (E,), np.float32),
        background_corr=np.ones(shape + (E,), np.float32),
        points=gt.Points([0.0], [0.0], [0], [0], gt.Cartesian),
        pobs=np.ones((1, E), np.float32),
        pratios=np.full(1, 0.1, np.float32),
        pbackground=np.zeros((1, E), np.float32),
        pbackground_corr=np.ones((1, E), np.float32),
        structure=gt.BarnesStructure(2500.0), max_points=10)
    if variant == "ebesc":
        del ok["background_corr"], ok["pbackground_corr"]
    if variant == "utem":
        ok["pobs"] = np.ones(1, np.float32)
    return ok


def _sweep_invalid(grid_form, variant):
    bad_bg = ([np.zeros((4, 2, E)), np.zeros((3, 3, E)), np.zeros((3, 2))]
              if grid_form else [np.zeros((4, E)), np.zeros(3)])
    invalid = {
        "background": bad_bg, "background_corr": bad_bg,
        "bratios": ([np.ones((4, 2)), np.ones((3, 3))] if grid_form
                    else [np.ones(4)]),
        "points": [gt.Points([0.0], [0.0]),
                   gt.Points([0, 1000.0], [0, 0], [0, 0], [0, 0],
                             gt.Cartesian)],
        "pobs": [np.ones(1, np.float32), np.ones((2, E), np.float32),
                 np.ones((1, E + 1), np.float32)],
        "pratios": [np.full(2, 0.1), np.full((1, 1), 0.1)],
        "pbackground": [np.zeros((2, E)), np.zeros(E), np.zeros((1, E + 1))],
        "pbackground_corr": [np.zeros((2, E)), np.zeros(E),
                             np.zeros((1, E + 1))],
        "max_points": [-1],
    }
    if variant == "ebesc":
        del invalid["background_corr"], invalid["pbackground_corr"]
    if variant == "utem":
        invalid["pobs"] = [np.ones((1, E), np.float32),
                           np.ones(2, np.float32)]
    return [(k, i, bad) for k, bads in invalid.items()
            for i, bad in enumerate(bads)]


SWEEP = [(variant, grid_form, key, i)
         for variant in VARIANTS for grid_form in (True, False)
         for key, i, _ in _sweep_invalid(grid_form, variant)]


@pytest.mark.parametrize(
    "variant,grid_form,key,i", SWEEP,
    ids=[f"{v}-{'grid' if g else 'points'}-{k}{i}" for v, g, k, i in SWEEP])
def test_multi_invalid_argument_sweep(route, variant, grid_form, key, i):
    args = _sweep_ok(grid_form, variant)
    args[key] = {(k, j): bad for k, j, bad in _sweep_invalid(
        grid_form, variant)}[(key, i)]
    fn = getattr(route, f"optimal_interpolation_ensi_multi_{variant}")
    with pytest.raises(ValueError, match="."):
        fn(*args.values())


@pytest.mark.parametrize("grid_form", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_multi_ok_args_actually_ok(route, variant, grid_form):
    args = _sweep_ok(grid_form, variant)
    fn = getattr(route, f"optimal_interpolation_ensi_multi_{variant}")
    out = fn(*args.values())
    assert out.shape == ((3, 2, E) if grid_form else (3, E))


# -- what every route owes its caller ----------------------------------------

def _six(d, e_d, owner, pkg=gt):
    """The six API functions of owner on _ensi_net's d and _multi_net's
    e_d."""
    b, pts = _objs(pkg, d)
    s = pkg.BarnesStructure(25000.0)
    bg2 = d["bg"][:, :, 0].copy()
    pback2 = d["pback"][:, 0].copy()
    ratios = np.full(pts.size(), 0.1, np.float32)
    out = [owner.optimal_interpolation(b, bg2, pts, d["pobs"], ratios,
                                       pback2, s, 8),
           *owner.optimal_interpolation_full(
               b, bg2, np.ones_like(bg2), pts, d["pobs"], ratios, pback2,
               np.ones_like(pback2), s, 8),
           owner.optimal_interpolation_ensi(b, d["bg"], pts, d["pobs"],
                                            d["sig"], d["pback"], s, 8)]
    for variant in VARIANTS:
        out.append(_multi(owner, variant, e_d, s, pkg=pkg))
    return out


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_outputs_are_fresh_and_inputs_untouched(device, monkeypatch):
    """No route hands back (or writes into) the caller's arrays, also
    when every member is valid and the member columns are not copied."""
    if device:
        for mod in (tapi, tensi, tmulti):
            monkeypatch.setattr(mod, "on_host", lambda: False)
    d, e_d = _ensi_net(seed=8), _multi_net(seed=8)
    before = {k: v.copy() for k, v in {**d, **{
        "m_" + k: v for k, v in e_d.items()}}.items()
        if isinstance(v, np.ndarray)}
    owner = _Both(tapi, tensi, tmulti) if device else gt
    outs = _six(d, e_d, owner)
    for out in outs:
        for v in list(d.values()) + list(e_d.values()):
            if isinstance(v, np.ndarray):
                assert not np.shares_memory(out, v)
    after = {k: v for k, v in {**d, **{
        "m_" + k: v for k, v in e_d.items()}}.items()
        if isinstance(v, np.ndarray)}
    for k in before:
        assert np.array_equal(before[k], after[k], equal_nan=True), k


class _Both:
    """The port's api modules as one namespace."""

    def __init__(self, *mods):
        self._mods = mods

    def __getattr__(self, name):
        for mod in self._mods:
            if hasattr(mod, name):
                return getattr(mod, name)
        raise AttributeError(name)


def test_device_route_passes_its_device_explicitly(monkeypatch):
    """Every tensor of the device route is made on the device the call
    read once (api_device), never on torch's default device: here the
    default is the meta device and the call's device the CPU, so a
    constructor that followed the default would fail the call."""
    for mod in (tapi, tensi, tmulti):
        monkeypatch.setattr(mod, "on_host", lambda: False)
        monkeypatch.setattr(mod, "api_device", lambda: torch.device("cpu"))
    d, e_d = _ensi_net(seed=9), _multi_net(seed=9)
    want = _six(d, e_d, _Both(tapi, tensi, tmulti))
    with torch.device("meta"):
        got = _six(d, e_d, _Both(tapi, tensi, tmulti))
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray)
        assert np.array_equal(a, b, equal_nan=True)
