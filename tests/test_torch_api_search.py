"""gridpp_tpu_torch's neighbourhood_search, smart and staticcorr_points
(api/search.py, ops/search.py) against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- neighbourhood_search, host route (the top-level, host-pinned function):
  both packages run the same native conditional mean (csrc nb_search),
  equal bit for bit;
- neighbourhood_search, device route run on the CPU (`on_host` patched to
  False in the port's api.search; gridpp_tpu's native search switched
  off, which gives its jitted op): rtol 1e-5, atol 1e-5; the op's bands
  give the same bits as one pass;
- smart and staticcorr_points (torch ops in the port, jnp in gridpp_tpu):
  rtol 1e-5, atol 1e-5; on exact rho ties both keep the lower candidate
  (jax.lax.top_k's order), and the row blocks give the same bits as one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.native as jnative  # noqa: E402
import gridpp_tpu_torch.api.search as tapi  # noqa: E402
from gridpp_tpu_torch.ops import search as tops  # noqa: E402

BAR = dict(rtol=1e-5, atol=1e-5)


def _fields(seed, shape=(40, 47)):
    """Temperature and a land-area fraction with missing cells in both."""
    rng = np.random.default_rng(seed)
    temp = rng.normal(280, 5, shape).astype(np.float32)
    laf = np.clip(rng.normal(0.6, 0.4, shape), 0, 1).astype(np.float32)
    temp[rng.random(shape) < 0.05] = np.nan
    laf[rng.random(shape) < 0.05] = np.nan
    apply = (rng.random(shape) < 0.7).astype(np.float32)
    return temp, laf, apply


SEARCH_CASES = [(7, 0.8, 1.0, 0.1, False), (1, 0.8, 1.0, 0.1, True),
                (3, 0.0, 0.2, 0.0, False), (5, 0.95, 1.0, 0.3, True),
                (0, 0.8, 1.0, 0.1, False), (60, 0.4, 0.5, 0.05, False)]


@pytest.mark.parametrize("h,tmin,tmax,delta,use_apply", SEARCH_CASES)
def test_search_host_route_bit_for_bit(h, tmin, tmax, delta, use_apply):
    temp, laf, apply = _fields(1)
    extra = (apply,) if use_apply else ()
    got = gt.neighbourhood_search(temp, laf, h, tmin, tmax, delta, *extra)
    want = gj.neighbourhood_search(temp, laf, h, tmin, tmax, delta, *extra)
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("h,tmin,tmax,delta,use_apply", SEARCH_CASES)
def test_search_device_route_matches_jax(monkeypatch, h, tmin, tmax, delta,
                                         use_apply):
    temp, laf, apply = _fields(2)
    extra = (apply * 1.5,) if use_apply else ()  # int32 1 gates, as in both
    monkeypatch.setattr(jnative, "nb_search", lambda *a, **k: None)
    want = gj.neighbourhood_search(temp, laf, h, tmin, tmax, delta, *extra)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    native = spy(monkeypatch, tapi.native, "nb_search")
    got = tapi.neighbourhood_search(temp, laf, h, tmin, tmax, delta, *extra)
    assert not native
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **BAR)


@pytest.mark.parametrize("h", [1, 4, 30])
def test_search_bands_give_one_pass_bits(monkeypatch, h):
    temp, laf, _ = _fields(3, (23, 31))
    a, s = torch.from_numpy(temp), torch.from_numpy(laf)
    w = (2 * min(h, 30) + 1) ** 2
    assert tops.band_rows(a.shape, h) >= 23
    whole = tops.neighbourhood_search(a, s, h, 0.7, 1.0, 0.1)
    for band in (1, 2, 5, 9):
        monkeypatch.setattr(tops, "BAND_BYTES", band * 31 * w
                            * tops._ELEM_BYTES)
        assert tops.band_rows(a.shape, h) == band
        got = tops.neighbourhood_search(a, s, h, 0.7, 1.0, 0.1)
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(whole))
    monkeypatch.setattr(tops, "BAND_BYTES", 1)
    assert tops.band_rows((2000, 2000), 7) == 1


def test_search_default_band_is_sized_from_memory(monkeypatch):
    """The API's device route with a budget of a few rows gives the one
    pass's bits."""
    temp, laf, _ = _fields(4)
    monkeypatch.setattr(tapi, "on_host", lambda: False)
    whole = tapi.neighbourhood_search(temp, laf, 5, 0.7, 1.0, 0.1)
    monkeypatch.setattr(tops, "BAND_BYTES", 3 * 47 * 121 * tops._ELEM_BYTES)
    assert tops.band_rows(temp.shape, 5) == 3
    got = tapi.neighbourhood_search(temp, laf, 5, 0.7, 1.0, 0.1)
    assert np.array_equal(got, whole, equal_nan=True)


@pytest.mark.parametrize("args", [dict(tmin=1.0, tmax=0.5), dict(h=-1),
                                  dict(shape=(5, 6)), dict(apply=(4, 4))])
def test_search_errors_match(args):
    temp = np.ones((4, 5), np.float32)
    laf = np.ones(args.get("shape", (4, 5)), np.float32)
    extra = (np.ones(args["apply"]),) if "apply" in args else ()
    call = (args.get("h", 1), args.get("tmin", 0.5), args.get("tmax", 1.0),
            0.1) + extra
    with pytest.raises(ValueError) as ej:
        gj.neighbourhood_search(temp, laf, *call)
    with pytest.raises(ValueError) as et:
        gt.neighbourhood_search(temp, laf, *call)
    assert str(et.value) == str(ej.value)


def _grids(pkg, seed, cartesian=False):
    rng = np.random.default_rng(seed)
    if cartesian:
        # integer coordinates: equal distances give exactly equal rho
        y, x = np.meshgrid(np.arange(30) * 1000.0, np.arange(36) * 1000.0,
                           indexing="ij")
        oy, ox = np.meshgrid(np.arange(12) * 2500.0 + 500,
                             np.arange(14) * 2500.0 + 500, indexing="ij")
        kw = dict(type=pkg.Cartesian)
        igrid = pkg.Grid(y, x, 0 * y, 0 * y, **kw)
        ogrid = pkg.Grid(oy, ox, 0 * oy, 0 * oy, **kw)
    else:
        lats, lons = np.meshgrid(np.linspace(59, 60, 30),
                                 np.linspace(10, 11.5, 36), indexing="ij")
        olats, olons = np.meshgrid(np.linspace(59.02, 59.98, 12),
                                   np.linspace(10.05, 11.4, 14),
                                   indexing="ij")
        igrid = pkg.Grid(lats, lons, rng.uniform(0, 500, lats.shape),
                         rng.uniform(0, 1, lats.shape))
        ogrid = pkg.Grid(olats, olons, rng.uniform(0, 500, olats.shape),
                         rng.uniform(0, 1, olats.shape))
    values = rng.normal(280, 5, (30, 36)).astype(np.float32)
    values[rng.random(values.shape) < 0.05] = np.nan
    return igrid, ogrid, values


@pytest.mark.parametrize("cartesian", [False, True])
@pytest.mark.parametrize("num", [1, 5, 40])
def test_smart_matches_jax(cartesian, num):
    out = {}
    for pkg in (gj, gt):
        igrid, ogrid, values = _grids(pkg, 5, cartesian)
        structure = pkg.BarnesStructure(4000.0, 200.0) if not cartesian \
            else pkg.BarnesStructure(3000.0)
        out[pkg] = pkg.smart(igrid, ogrid, values, num, structure)
    assert out[gt].dtype == np.float32 and out[gt].shape == (12, 14)
    assert np.array_equal(np.isnan(out[gt]), np.isnan(out[gj]))
    np.testing.assert_allclose(out[gt], out[gj], **BAR)


def test_smart_exact_ties_keep_the_lower_candidate():
    """Each output cell at the centre of four input cells of an integer
    Cartesian grid: the four tie exactly on rho, and num=2 keeps the two
    lower indices in both packages (jax.lax.top_k's order)."""
    out = {}
    for pkg in (gj, gt):
        y, x = np.meshgrid(np.arange(30) * 1000.0, np.arange(36) * 1000.0,
                           indexing="ij")
        oy, ox = np.meshgrid(np.arange(12) * 2000.0 + 500,
                             np.arange(14) * 2000.0 + 500, indexing="ij")
        igrid = pkg.Grid(y, x, 0 * y, 0 * y, type=pkg.Cartesian)
        ogrid = pkg.Grid(oy, ox, 0 * oy, 0 * oy, type=pkg.Cartesian)
        values = np.arange(30 * 36, dtype=np.float32).reshape(30, 36)
        out[pkg] = pkg.smart(igrid, ogrid, values, 2,
                             pkg.BarnesStructure(1000.0))
    r, c = np.meshgrid(np.arange(12) * 2, np.arange(14) * 2, indexing="ij")
    want = (r * 36 + c + 0.5).astype(np.float32)
    assert np.array_equal(out[gj], want)
    assert np.array_equal(out[gt], want)


def test_smart_blocks_give_one_pass_bits(monkeypatch):
    igrid, ogrid, values = _grids(gt, 7)
    structure = gt.BarnesStructure(4000.0)
    whole = gt.smart(igrid, ogrid, values, 5, structure)
    monkeypatch.setattr(tapi, "_BLOCK_BYTES", 1)  # one row a block
    blocks = spy(monkeypatch, tapi, "_select_top")
    got = gt.smart(igrid, ogrid, values, 5, structure)
    assert len(blocks) == 12 * 14
    assert np.array_equal(got, whole, equal_nan=True)


def _points(pkg, seed, n, m):
    rng = np.random.default_rng(seed)
    pts = pkg.Points(rng.uniform(59, 60, n), rng.uniform(10, 11.5, n),
                     rng.uniform(0, 500, n), rng.uniform(0, 1, n))
    knots = pkg.Points(rng.uniform(59, 60, m), rng.uniform(10, 11.5, m),
                       rng.uniform(0, 500, m), rng.uniform(0, 1, m))
    return pts, knots


@pytest.mark.parametrize("max_points", [0, 1, 8])
@pytest.mark.parametrize("structure", ["Barnes", "Cressman"])
def test_staticcorr_points_matches_jax(max_points, structure):
    out = {}
    for pkg in (gj, gt):
        pts, knots = _points(pkg, 8, 70, 45)
        st = pkg.BarnesStructure(15000.0, 300.0) if structure == "Barnes" \
            else pkg.CressmanStructure(20000.0)
        out[pkg] = pkg.staticcorr_points(pts, knots, st, max_points)
    assert out[gt].dtype == np.float32 and out[gt].shape == (70, 45)
    assert np.array_equal(out[gt] != 0, out[gj] != 0)
    np.testing.assert_allclose(out[gt], out[gj], **BAR)


def test_staticcorr_points_blocks_and_unpinned(monkeypatch):
    pts, knots = _points(gt, 9, 50, 30)
    st = gt.BarnesStructure(15000.0)
    whole = gt.staticcorr_points(pts, knots, st, 6)
    monkeypatch.setattr(tapi, "_BLOCK_BYTES", 1)
    assert np.array_equal(tapi.staticcorr_points(pts, knots, st, 6), whole)


@pytest.mark.parametrize("case", ["negative", "coordinates", "empty"])
def test_staticcorr_points_edges_match(case):
    def call(pkg):
        pts, knots = _points(pkg, 10, 5, 4)
        if case == "coordinates":
            knots = pkg.Points([0.0], [0.0], [0.0], [0.0], pkg.Cartesian)
        if case == "empty":
            knots = pkg.Points([], [], [], [])
        return pkg.staticcorr_points(pts, knots, pkg.BarnesStructure(1e4),
                                     -1 if case == "negative" else 3)

    if case == "empty":
        assert np.array_equal(call(gt), call(gj))
        return
    with pytest.raises(ValueError) as ej:
        call(gj)
    with pytest.raises(ValueError) as et:
        call(gt)
    assert str(et.value) == str(ej.value)


def test_smart_selection_follows_the_last_bit_of_rho(monkeypatch):
    """ROADMAP F13: at the four-way exact ties above, raising by one ulp
    the rho of the candidates east of each cell turns smart's choice to
    them: a selection this close follows the last bit of rho, which the
    card's exp and the CPU's may round apart."""
    y, x = np.meshgrid(np.arange(30) * 1000.0, np.arange(36) * 1000.0,
                       indexing="ij")
    oy, ox = np.meshgrid(np.arange(12) * 2000.0 + 500,
                         np.arange(14) * 2000.0 + 500, indexing="ij")
    igrid = gt.Grid(y, x, 0 * y, 0 * y, type=gt.Cartesian)
    ogrid = gt.Grid(oy, ox, 0 * oy, 0 * oy, type=gt.Cartesian)
    values = np.arange(30 * 36, dtype=np.float32).reshape(30, 36)
    structure = gt.BarnesStructure(1000.0)
    tie = gt.smart(igrid, ogrid, values, 2, structure)
    real = type(structure).corr_torch

    def nudged(self, p1, p2):
        rho = real(self, p1, p2)
        east = p2["x"] > p1["x"]
        return torch.where(east, torch.nextafter(rho, rho + 1), rho)

    monkeypatch.setattr(type(structure), "corr_torch", nudged)
    got = gt.smart(igrid, ogrid, values, 2, structure)
    r, c = np.meshgrid(np.arange(12) * 2, np.arange(14) * 2, indexing="ij")
    # the two eastern cells (r, c + 1) and (r + 1, c + 1)
    assert np.array_equal(got, (r * 36 + c + 1 + 18).astype(np.float32))
    assert not np.array_equal(got, tie)
