"""gridpp_tpu_torch's deterministic OI numpy API (api/oi.py on ops/oi.py
and the native host solver) against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- host route (the top-level, host-pinned functions): both packages run the
  same native C++ solver on the same inputs, so the outputs are equal bit
  for bit (np.array_equal, NaN equal) for every native-kernel structure of
  tests/test_optimal_interpolation.py:435-473, Grid and Points forms, with
  and without extrapolation;
- host route with the native solver switched off in both packages: the
  port's torch block solver against gridpp_tpu's XLA one at the bars of
  tests/test_optimal_interpolation.py:421-433 (atol 2e-4, rtol 1e-5 on
  >= 99.5% of the interior cells, max relative 5e-3) and :495;
- device route run on the CPU (`on_host` patched to False in both
  packages' api modules; nothing in gridpp_tpu changes): the shortlist,
  dense and host-candidate paths within 1e-4 of gridpp_tpu's same path
  (PERF.md §2), and the shortlist route equal bit for bit to the port's
  flat Pipeline;
- selection: on exact rho ties the lower obs index wins, as
  jax.lax.top_k does (ROADMAP F2), on narrow (sorted) and wide (top-k on a
  unique key) rows;
- ROADMAP F4: the chunked native solve fed by the canonical shortlist
  equals the ball-query-fed one bit for bit;
- the reference's invalid-argument sweep and behavioural cases
  (tests/test_optimal_interpolation.py:12-173) against the port's
  namespace, on the host route and on the device route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import (gj, gt, objects, obs_values, problem,  # noqa: E402
                            spy)
import gridpp_tpu.api._common as jcommon  # noqa: E402
import gridpp_tpu.api.oi as japi  # noqa: E402
import gridpp_tpu.ops.oi as jops  # noqa: E402
import gridpp_tpu_torch.api.oi as tapi  # noqa: E402
import gridpp_tpu_torch.ops.oi as tops  # noqa: E402
from gridpp_tpu_torch import native  # noqa: E402

DEVICE_TOL = 1e-4  # PERF.md §2: the port's OI bar

# tests/test_optimal_interpolation.py:435-473
_SRNG = np.random.default_rng(7)
_SLATS, _SLONS = np.meshgrid(np.linspace(55, 57, 30), np.linspace(5, 7, 30),
                             indexing="ij")
_SH = _SRNG.uniform(15000, 40000, (30, 30)).astype(np.float32)
NATIVE = {
    "barnes": lambda pkg: pkg.BarnesStructure(20000.0, 200.0, 0.3),
    "barnes_hmax": lambda pkg: pkg.BarnesStructure(20000.0, 0.0, 0.0,
                                                   30000.0),
    "cressman": lambda pkg: pkg.CressmanStructure(30000.0, 300.0, 0.5),
    "soar": lambda pkg: pkg.SoarStructure(15000.0, 200.0, 0.0),
    "toar": lambda pkg: pkg.ToarStructure(15000.0, 0.0, 0.4),
    "powerlaw": lambda pkg: pkg.PowerlawStructure(15000.0, 250.0, 0.0),
    "spatial_barnes": lambda pkg: pkg.BarnesStructure(
        pkg.Grid(_SLATS, _SLONS), _SH, np.full((30, 30), 200.0, np.float32),
        np.zeros((30, 30), np.float32)),
}
# structures the native solver does not take: the torch block solver is
# their host route in both settings
OTHER = {
    "multiple": lambda pkg: pkg.MultipleStructure(
        pkg.BarnesStructure(20000.0), pkg.BarnesStructure(20000.0, 200.0),
        pkg.BarnesStructure(20000.0, 0.0, 0.3)),
    "cross_validation": lambda pkg: pkg.CrossValidation(
        pkg.BarnesStructure(20000.0, 200.0, 0.3), 750.0),
}


def _net(seed=0, ny=40, nx=50, p=150, nan_every=17):
    """tests/test_optimal_interpolation.py:369-387: elevations and land
    fractions on grid and obs, one NaN background cell, every
    nan_every-th obs missing."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, ny), np.linspace(5, 8, nx),
                             indexing="ij")
    d = dict(lats=lats, lons=lons,
             elevs=rng.uniform(0, 800, (ny, nx)).astype(np.float32),
             lafs=rng.uniform(0, 1, (ny, nx)).astype(np.float32),
             plats=rng.uniform(55.05, 57.95, p),
             plons=rng.uniform(5.05, 7.95, p),
             pelev=rng.uniform(0, 700, p), plaf=rng.uniform(0, 1, p))
    bg = rng.normal(280, 5, (ny, nx)).astype(np.float32)
    bg[3, 4] = np.nan
    nn = gt.Grid(lats, lons).nearest_map(d["plats"], d["plons"])
    pback = bg.reshape(-1)[nn]
    pobs = (pback + rng.normal(0, 1, p)).astype(np.float32)
    pobs[::nan_every] = np.nan
    d.update(bg=bg, pback=pback, pobs=pobs,
             ratios=np.full(p, 0.1, np.float32),
             bvar=rng.uniform(0.5, 2, (ny, nx)).astype(np.float32),
             pbvar=rng.uniform(0.5, 2, p).astype(np.float32))
    return d


def _build(pkg, d, form="grid", monotone=False):
    """(background object, obs Points) of package pkg for _net's d."""
    if form == "grid":
        b = pkg.Grid(d["lats"], d["lons"], d["elevs"], d["lafs"])
    else:
        b = pkg.Points(d["lats"].ravel(), d["lons"].ravel(),
                       d["elevs"].ravel(), d["lafs"].ravel())
    p = d["plats"].size
    pelev = np.zeros(p) if monotone else d["pelev"]
    plaf = np.zeros(p) if monotone else d["plaf"]
    return b, pkg.Points(d["plats"], d["plons"], pelev, plaf)


def _field(d, key, form):
    return d[key] if form == "grid" else d[key].ravel()


def _both(d, form, make, *, allow=True, max_points=10, full=False):
    """optimal_interpolation (or _full) through both packages' top level:
    {pkg: output}."""
    out = {}
    for pkg in (gj, gt):
        b, pts = _build(pkg, d, form)
        s = make(pkg)
        if full:
            out[pkg] = pkg.optimal_interpolation_full(
                b, _field(d, "bg", form), _field(d, "bvar", form), pts,
                d["pobs"], d["ratios"], d["pback"], d["pbvar"], s,
                max_points, allow)
        else:
            out[pkg] = pkg.optimal_interpolation(
                b, _field(d, "bg", form), pts, d["pobs"], d["ratios"],
                d["pback"], s, max_points, allow)
    return out


@pytest.fixture
def device_route(monkeypatch):
    """Both packages' API takes its device route on the CPU."""
    for mod in (japi, jcommon, tapi):
        monkeypatch.setattr(mod, "on_host", lambda: False)


# -- host route ------------------------------------------------------------

def test_native_library_builds():
    assert native.get_lib() is not None


@pytest.mark.parametrize("full", [False, True], ids=["oi", "full"])
@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("form", ["grid", "points"])
@pytest.mark.parametrize("name", list(NATIVE))
def test_host_route_bit_for_bit(name, form, allow, full):
    d = _net(seed=len(name) + 3 * allow)
    out = _both(d, form, NATIVE[name], allow=allow, full=full)
    want, got = out[gj], out[gt]
    if not full:
        want, got = (want,), (got,)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("max_points", [0, 10])
def test_host_route_all_in_radius_bit_for_bit(max_points):
    """max_points=0 (every in-radius obs) and a large cap take the same
    native path."""
    d = _net(seed=11)
    out = _both(d, "grid", NATIVE["barnes"], max_points=max_points)
    assert np.array_equal(out[gj], out[gt], equal_nan=True)


def _interior(d, structure):
    """Cells with no obs within 5 cm of the localization radius
    (tests/test_optimal_interpolation.py:409-415)."""
    b, pts = _build(gt, d)
    bp = b.to_points()
    dist = np.sqrt(((bp.xyz[:, None, :] - pts.xyz[None, :, :]) ** 2).sum(-1))
    locv = structure.localization_np(bp.lats, bp.lons)
    return ~(np.abs(dist - locv[:, None]) < 0.05).any(axis=1).reshape(
        d["bg"].shape)


def _at_reference_bars(got, want, interior=None, share=0.995):
    """tests/test_optimal_interpolation.py:421-433."""
    if interior is None:
        interior = np.ones(got.shape, bool)
    close = np.isclose(got[interior], want[interior], atol=2e-4, rtol=1e-5,
                       equal_nan=True)
    assert close.mean() > share, f"{(~close).sum()} cells mismatch"
    rel = np.abs(got - want)[interior] / np.maximum(np.abs(want), 1.0)[
        interior]
    assert np.nanmax(rel) < 5e-3


# tests/test_optimal_interpolation.py:435-473: (structure, seed, allow)
XLA_CASES = [("barnes", 0, True), ("barnes_hmax", 1, True),
             ("barnes", 2, False), ("cressman", 3, True), ("soar", 4, True),
             ("toar", 5, True), ("powerlaw", 6, True),
             ("spatial_barnes", 7, True), ("multiple", 10, True),
             ("cross_validation", 11, False)]


@pytest.mark.parametrize("name,seed,allow", XLA_CASES)
def test_host_torch_solver_matches_xla(name, seed, allow, monkeypatch):
    """Native solver off in both packages: the port's torch block solver
    (ops/oi.oi_gather_block) against gridpp_tpu's XLA kernel. The strict
    check (every in-radius obs, interior cells) runs on a 20 x 25 cut of
    the reference's 40 x 50 grid: its S x S systems hold ~140 obs, and
    the f32 solve of both packages is cubic in S."""
    make = {**NATIVE, **OTHER}[name]
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "_native_kernel_type", lambda s: None)
    calls = spy(monkeypatch, tapi, "oi_gather_block")
    small = _net(seed, ny=20, nx=25)
    interior = _interior(small, make(gt))
    assert interior.mean() > 0.9
    out0 = _both(small, "grid", make, allow=allow, max_points=0)
    _at_reference_bars(out0[gt], out0[gj], interior)
    d = _net(seed)
    out10 = _both(d, "grid", make, allow=allow, max_points=10)
    _at_reference_bars(out10[gt], out10[gj], share=0.99)
    assert calls


def test_host_torch_solver_variance_matches_xla(monkeypatch):
    """tests/test_optimal_interpolation.py:483-496."""
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "_native_kernel_type", lambda s: None)
    d = _net(seed=9)
    out = _both(d, "grid", NATIVE["barnes"], full=True)
    for got, want in zip(out[gt], out[gj]):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)


# -- ROADMAP F4 --------------------------------------------------------------

def test_chunked_shortlist_feed_equals_ball_feed(monkeypatch):
    """The chunked host path (forced at a small size) fed by the canonical
    shortlist equals the ball-query-fed one bit for bit on a network where
    monotone_obs holds (obs elevations and land fractions uniform)."""
    from gridpp_tpu_torch.ops.canonical import monotone_obs
    monkeypatch.setattr(tapi, "_BALL_QUERY_MAX", 500)
    monkeypatch.setattr(tapi, "_BLOCK", 512)
    d = _net(seed=8)
    b, pts = _build(gt, d, monotone=True)
    s = gt.BarnesStructure(20000.0, 150.0, 0.3)
    assert monotone_obs(s, pts)
    feeds = []
    real = tapi._chunked_shortlist

    def record(*a, **k):
        feeds.append(real(*a, **k))
        return feeds[-1]

    monkeypatch.setattr(tapi, "_chunked_shortlist", record)
    args = (b, d["bg"], d["bvar"], pts, d["pobs"], d["ratios"], d["pback"],
            d["pbvar"], s, 8)
    sl_fed = gt.optimal_interpolation_full(*args)
    assert feeds and feeds[0] is not None  # the shortlist fed the solver
    monkeypatch.setattr(tapi, "_chunked_shortlist", lambda *a, **k: None)
    ball_fed = gt.optimal_interpolation_full(*args)
    for a, c in zip(sl_fed, ball_fed):
        assert np.array_equal(a, c, equal_nan=True)
    assert not np.array_equal(sl_fed[0], d["bg"], equal_nan=True)


# -- device route, run on the CPU --------------------------------------------

def test_device_shortlist_route(device_route, monkeypatch):
    """The canonical-shortlist sweep: within 1e-4 of gridpp_tpu's
    shortlist sweep, and equal bit for bit to the port's flat Pipeline on
    the same shortlist."""
    sl_calls = spy(monkeypatch, tapi, "_oi_points_shortlist")
    dense = spy(monkeypatch, tapi, "_oi_points_dense")
    d = _net(seed=2)
    out = _both(d, "grid", NATIVE["barnes"], max_points=8)
    assert sl_calls and not dense
    np.testing.assert_allclose(out[gt], out[gj], rtol=0, atol=DEVICE_TOL)
    b, pts = _build(gt, d)
    s = NATIVE["barnes"](gt)
    api = tapi.optimal_interpolation(b, d["bg"], pts, d["pobs"],
                                     d["ratios"], d["pback"], s, 8)
    pipe = gt.Pipeline(b, pts, s, halfwidth=0, max_points=8, tiled=False,
                       device="cpu")
    flat = pipe.run_device(torch.as_tensor(d["bg"]),
                           torch.as_tensor(d["pobs"]), d["ratios"],
                           path="general").numpy()
    assert np.array_equal(api, flat, equal_nan=True)


def test_device_full_variance(device_route):
    d = _net(seed=4)
    out = _both(d, "points", NATIVE["barnes"], full=True)
    for got, want in zip(out[gt], out[gj]):
        np.testing.assert_allclose(got, want, rtol=0, atol=DEVICE_TOL)
    assert np.nanmax(out[gt][1]) <= np.nanmax(d["bvar"]) + 1e-5


def _dense_net(seed=5, n=6000, p=1500):
    """Cartesian points over 100 km x 100 km and a dense network with half
    its obs missing: truncated shortlist rows starve, and n x (valid obs) >
    4e6 sends the device route to the dense sweep."""
    rng = np.random.default_rng(seed)
    d = dict(y=rng.uniform(0, 1e5, n), x=rng.uniform(0, 1e5, n),
             py=rng.uniform(0, 1e5, p), px=rng.uniform(0, 1e5, p))
    d["bg"] = rng.normal(0, 1, n).astype(np.float32)
    d["pback"] = rng.normal(0, 1, p).astype(np.float32)
    d["pobs"] = (d["pback"] + rng.normal(0, 0.5, p)).astype(np.float32)
    d["pobs"][rng.random(p) < 0.5] = np.nan
    d["ratios"] = np.full(p, 0.1, np.float32)
    return d


def test_device_dense_route(device_route, monkeypatch):
    # gridpp_tpu pads the dense sweep to whole blocks: keep them small here
    monkeypatch.setattr(japi, "_BLOCK", 8192)
    dense = {pkg: spy(monkeypatch, mod, "_oi_points_dense")
             for pkg, mod in ((gj, japi), (gt, tapi))}
    d = _dense_net()
    assert np.isfinite(d["pobs"]).sum() * d["bg"].size > 4_000_000
    out = {}
    for pkg in (gj, gt):
        b = pkg.Points(d["y"], d["x"], type=pkg.Cartesian)
        pts = pkg.Points(d["py"], d["px"], type=pkg.Cartesian)
        out[pkg] = pkg.optimal_interpolation(
            b, d["bg"], pts, d["pobs"], d["ratios"], d["pback"],
            pkg.BarnesStructure(5000.0, 0.0), 10)
    assert dense[gj] and dense[gt]
    np.testing.assert_allclose(out[gt], out[gj], rtol=0, atol=DEVICE_TOL)
    assert np.abs(out[gt] - d["bg"]).max() > 0.1


def test_device_host_candidate_route(device_route, monkeypatch):
    """A starved shortlist row on a network too small for the dense sweep:
    the host-candidate block solver on the device."""
    block = spy(monkeypatch, tapi, "oi_gather_block")
    dense = spy(monkeypatch, tapi, "_oi_points_dense")
    d = _net(seed=6, nan_every=2)
    d["pobs"][1::3] = np.nan
    out = _both(d, "grid", NATIVE["barnes"], max_points=8)
    assert block and not dense
    np.testing.assert_allclose(out[gt], out[gj], rtol=0, atol=DEVICE_TOL)


@pytest.mark.parametrize("name", ["cressman", "spatial_barnes", "multiple"])
def test_device_route_other_structures(name, device_route):
    make = {**NATIVE, **OTHER}[name]
    d = _net(seed=30 + len(name))
    out = _both(d, "grid", make, max_points=8)
    np.testing.assert_allclose(out[gt], out[gj], rtol=0, atol=DEVICE_TOL)


def test_device_caches_keyed_on_device(device_route):
    """Tensors cached on Points objects carry the device in their key, so
    a host call and a device call in one process never share them."""
    d = _net(seed=12)
    b, pts = _build(gt, d)
    s = NATIVE["barnes"](gt)
    tapi.optimal_interpolation(b, d["bg"], pts, d["pobs"], d["ratios"],
                               d["pback"], s, 8)
    keys = list(pts.__dict__["_dev_field_cache"]) + list(
        b.to_points().__dict__["_canon_dev_cache"])
    assert keys and all(k[-1] == torch.device("cpu") for k in keys)


def test_device_all_in_radius_candidates_in_row_blocks(device_route,
                                                       monkeypatch):
    """max_points 0 past _candidates' exact query size: the ball query's
    lists in blocks of rows (`_ball_fetch`, no k-nearest query of the whole
    network), so the host-candidate solver gives the same bits as on the
    exact query's lists."""
    d = _net(seed=13)
    s = NATIVE["barnes"](gt)

    def run():
        b, pts = _build(gt, d)
        return tapi.optimal_interpolation(b, d["bg"], pts, d["pobs"],
                                          d["ratios"], d["pback"], s, 0)

    want = run()
    monkeypatch.setattr(tapi, "_BALL_QUERY_MAX", 64)
    fetches = spy(monkeypatch, tapi, "_ball_fetch")
    got = run()
    assert fetches == [1]
    assert np.array_equal(got, want, equal_nan=True)
    assert not np.array_equal(got, d["bg"], equal_nan=True)


# -- selection on exact ties (ROADMAP F2) ------------------------------------

@pytest.mark.parametrize("width", [40, 300])
def test_select_top_lower_index_wins_ties(width):
    rng = np.random.default_rng(width)
    rho = rng.integers(1, 6, (64, width)).astype(np.float32) / 5
    valid = rng.random((64, width)) < 0.8
    vals, sel, ok = tops._select_top(torch.as_tensor(rho),
                                     torch.as_tensor(valid), 10)
    jv, js, jok = jops._select_top(jnp.asarray(rho), jnp.asarray(valid), 10)
    assert np.array_equal(sel.numpy(), np.asarray(js))
    assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert np.array_equal(ok.numpy(), np.asarray(jok))


def test_dense_block_exact_rho_ties():
    """Obs stacked in pairs at one position (exact rho ties) with different
    values: the dense selection keeps the lower index of each pair, as
    gridpp_tpu's lax.top_k, so the two packages agree."""
    rng = np.random.default_rng(3)
    n, pairs = 50, 150
    py = np.repeat(rng.uniform(0, 2e4, pairs), 2)
    px = np.repeat(rng.uniform(0, 2e4, pairs), 2)
    b_y, b_x = rng.uniform(0, 2e4, n), rng.uniform(0, 2e4, n)
    obs = rng.normal(0, 1, 2 * pairs).astype(np.float32)
    obs_y = np.zeros(2 * pairs, np.float32)
    ratios = np.full(2 * pairs, 0.3, np.float32)
    bg = np.zeros(n, np.float32)
    out = {}
    for pkg, ops, conv in ((gj, jops, jnp.asarray), (gt, tops,
                                                     torch.as_tensor)):
        s = pkg.BarnesStructure(4000.0, 0.0)
        bp = pkg.Points(b_y, b_x, type=pkg.Cartesian)
        op = pkg.Points(py, px, type=pkg.Cartesian)
        api = japi if pkg is gj else tapi
        origin = api._origin(bp)
        p1 = {k: conv(v)[:, None] for k, v in api._resolved_fields(
            bp, s, origin).items()}
        of = {k: conv(v) for k, v in api._resolved_fields(
            op, s, origin).items()}
        res = ops.oi_block_dense(s, p1, of, conv(bg), conv(np.ones_like(bg)),
                                 conv(obs), conv(obs_y), conv(ratios), 1,
                                 True)
        out[pkg] = np.asarray(res[0])
    np.testing.assert_allclose(out[gt], out[gj], rtol=0, atol=1e-5)
    # the higher index of a pair would pull toward its own value (p1, of,
    # s and conv are the port's from the last pass of the loop)
    swapped = obs.reshape(-1, 2)[:, ::-1].ravel().copy()
    t_alt = tops.oi_block_dense(
        s, p1, of, conv(bg), conv(np.ones_like(bg)), conv(swapped),
        conv(obs_y), conv(ratios), 1, True)[0].numpy()
    assert np.abs(t_alt - out[gt]).max() > 1e-2


# -- the reference's behavioural cases (tests/test_optimal_interpolation.py
# :12-173), on the port's namespace -------------------------------------------

@pytest.fixture(params=["host", "device"])
def route(request, monkeypatch):
    """The port's top level (host route), or its api module with the
    device route taken on the CPU."""
    if request.param == "host":
        return gt
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    return tapi


def _ok_args():
    return dict(
        grid=gt.Grid([[0, 0, 0]], [[0, 2500, 10000]], [[0, 0, 0]],
                     [[0, 0, 0]], gt.Cartesian),
        background=np.zeros([1, 3]),
        points=gt.Points([0], [2500], [0], [0], gt.Cartesian),
        pobs=[1], pratios=[0.1], pbackground=[0],
        structure=gt.BarnesStructure(2500), max_points=10)


_X = np.zeros([3, 2])
INVALID = [
    ("grid", lambda: gt.Grid(_X, _X, _X, _X, gt.Cartesian)),
    ("grid", lambda: gt.Grid([[0, 0, 0]], [[0, 2500, 10000]])),
    ("points", lambda: gt.Points([0, 1], [0, 2500], [0, 0], [0, 0],
                                 gt.Cartesian)),
    ("points", lambda: gt.Points([0], [2500])),
    ("pratios", lambda: np.zeros(11)),
    ("pobs", lambda: np.zeros([11])),
    ("background", lambda: np.zeros([2, 11])),
    ("pbackground", lambda: np.zeros(21)),
    ("max_points", lambda: -1),
]


@pytest.mark.parametrize("key,bad", INVALID,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(INVALID)])
def test_invalid_arguments(route, key, bad):
    args = _ok_args()
    args[key] = bad()
    with pytest.raises(ValueError):
        route.optimal_interpolation(*args.values())


def test_ok_arguments(route):
    out = route.optimal_interpolation(*_ok_args().values())
    assert out.shape == (1, 3) and out[0, 1] > 0


def test_simple_1d(route):
    grid = gt.Grid([[0, 0, 0]], [[0, 2500, 10000]], [[0, 0, 0]],
                   [[0, 0, 0]], gt.Cartesian)
    points = gt.Points([0], [2500], [0], [0], gt.Cartesian)
    output = route.optimal_interpolation(
        grid, np.zeros([1, 3]), points, [1], [0.1], [0],
        gt.BarnesStructure(2500), 10)
    np.testing.assert_array_almost_equal(
        output, np.array([[np.exp(-0.5) / 1.1, 1 / 1.1,
                           np.exp(-0.5 * 9) / 1.1]]), decimal=5)


def test_simple_grid_full(route):
    grid = gt.Grid([[0, 0, 0]], [[0, 2500, 10000]], [[0, 0, 0]],
                   [[0, 0, 0]], gt.Cartesian)
    points = gt.Points([0], [2500], [0], [0], gt.Cartesian)
    _, variance = route.optimal_interpolation_full(
        grid, np.zeros([1, 3]), np.ones([1, 3]), points, [1], [0.1], [0],
        [1], gt.BarnesStructure(2500), 10)
    assert variance[0, 1] == pytest.approx(0.1 / 1.1, abs=1e-5)


def test_simple_points_full(route):
    y, x = [0, 0, 0], [0, 2500, 10000]
    bpoints = gt.Points(y, x, y, y, gt.Cartesian)
    points = gt.Points([0], [2500], [0], [0], gt.Cartesian)
    _, variance = route.optimal_interpolation_full(
        bpoints, np.zeros(3), np.ones(3), points, np.array([1]),
        np.array([0.1]), np.array([0]), np.array([1]),
        gt.BarnesStructure(2500), 10)
    assert variance[1] == pytest.approx(0.1 / 1.1, abs=1e-5)


def test_missing_values(route):
    obs = np.array([1, np.nan, 2, 3, np.nan, np.nan, 4, np.nan])
    n = len(obs)
    y = np.arange(0, n * 1000, 1000).astype(np.float64)
    background = np.zeros(n)
    points = gt.Points(y, np.zeros(n), np.zeros(n), np.zeros(n),
                       gt.Cartesian)
    ratios = np.ones(n)
    structure = gt.BarnesStructure(1000, 0)
    analysis = route.optimal_interpolation(
        points, background, points, obs, ratios, background, structure, 100)
    keep = np.where(np.isfinite(obs))[0]
    points1 = gt.Points(y[keep], np.zeros(len(keep)), np.zeros(len(keep)),
                        np.zeros(len(keep)), gt.Cartesian)
    analysis1 = route.optimal_interpolation(
        points, background, points1, obs[keep], ratios[keep],
        background[keep], structure, 100)
    np.testing.assert_array_almost_equal(analysis, analysis1, decimal=5)


def test_extrapolation(route):
    n = 5
    y = np.linspace(0, 1000, n)
    x = np.zeros(n)
    bpoints = gt.Points(y, x, x, x, gt.Cartesian)
    points = gt.Points([0, 100, 900, 1000], [0, 0, 0, 0], [0, 0, 0, 0],
                       [0, 0, 0, 0], gt.Cartesian)
    args = (bpoints, np.zeros(n), points, [0, 1, 1, 0], 0.1 * np.ones(4),
            np.zeros(4), gt.BarnesStructure(500), 10)
    output0 = route.optimal_interpolation(*args, False)
    output1 = route.optimal_interpolation(*args, True)
    assert np.max(output0) == pytest.approx(1, abs=1e-5)
    assert np.max(output1) > 1
    idx = np.where(output1 < 1)[0]
    np.testing.assert_array_almost_equal(output0[idx], output1[idx],
                                         decimal=5)


def test_no_obs(route):
    output = route.optimal_interpolation(
        gt.Points([0], [0]), np.zeros(1), gt.Points([], []), [], [], [],
        gt.BarnesStructure(500), 10)
    np.testing.assert_almost_equal(output, np.zeros(1))


def test_nan_background(route):
    grid = gt.Grid([[0, 0]], [[0, 1000]], [[0, 0]], [[0, 0]], gt.Cartesian)
    points = gt.Points([0], [0], [0], [0], gt.Cartesian)
    out = route.optimal_interpolation(
        grid, np.array([[np.nan, 0.0]], np.float32), points, [1], [0.1], [0],
        gt.BarnesStructure(2500), 10)
    assert np.isnan(out[0, 0])
    assert out[0, 1] > 0


def test_max_points_limits(route):
    y = np.array([0., 1000., 2000.])
    bpoints = gt.Points(y, np.zeros(3), np.zeros(3), np.zeros(3),
                        gt.Cartesian)
    points = gt.Points([0., 2000.], [0, 0], [0, 0], [0, 0], gt.Cartesian)
    out1 = route.optimal_interpolation(
        bpoints, np.zeros(3), points, [1., 2.], [0.1, 0.1], [0., 0.],
        gt.BarnesStructure(1000), 1)
    assert out1[0] == pytest.approx(1 / 1.1, abs=1e-4)
    assert out1[2] == pytest.approx(2 / 1.1, abs=1e-4)


def test_top_level_is_host_pinned():
    """The top-level functions run with the CPU as torch's default
    device, whatever the caller's default."""
    from gridpp_tpu_torch.api._common import api_device
    seen = []
    real = tapi._oi_points

    def record(*a, **k):
        seen.append(api_device())
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "_oi_points", record)
        with torch.device("meta"):
            out = gt.optimal_interpolation(*_ok_args().values())
    assert seen == [torch.device("cpu")]
    assert getattr(gt.optimal_interpolation, "__wrapped_host_pin__", False)
    assert out.shape == (1, 3)


def test_problem_helper_network_matches_pipeline_api():
    """The shared helper's network (tests/_torch_helpers.problem) through
    the port's host API equals gridpp_tpu's bit for bit."""
    prob = problem(0)
    grid, pts, sj = objects(gj, prob)
    g2, p2, st = objects(gt, prob)
    pback, pobs = obs_values(prob, grid)
    a = gj.optimal_interpolation(grid, prob["background"], pts, pobs,
                                 prob["ratios"], pback, sj, 8)
    b = gt.optimal_interpolation(g2, prob["background"], p2, pobs,
                                 prob["ratios"], pback, st, 8)
    assert np.array_equal(a, b, equal_nan=True)
    assert jax.default_backend() == "cpu"
