"""gridpp_tpu_torch's downscaling API, its host copies (BilinearMap, KDTree)
and ops/downscaling.py against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- the host copies: every array of the bilinear map (corner and nearest
  indices, s, t, the inside mask) and every KDTree query equal bit for
  bit;
- nearest: equal (a gather of the same values through the same map);
- bilinear: rtol 1e-6, atol 1e-4 (an f32 blend of the same gathers);
- the device route (the module functions, unpinned) on the CPU at the same
  bars; the map's tensors are uploaded once per (target, device).
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.core.bilinear_weights as jbw  # noqa: E402
import gridpp_tpu.ops.downscaling as jops  # noqa: E402
import gridpp_tpu_torch.api.downscaling as tapi  # noqa: E402
import gridpp_tpu_torch.core.bilinear_weights as tbw  # noqa: E402
import gridpp_tpu_torch.ops.downscaling as tops  # noqa: E402

RTOL, ATOL = 1e-6, 1e-4


def _grids(seed=0, curvy=False):
    """(source lats, lons, elevs), (target lats, lons, elevs), (point lats,
    lons, elevs): a 30 x 40 source over 55-58N 5-9E (rotated and bent
    when curvy), a finer 45 x 50 target reaching past its edges, and 60
    points of which a few lie outside the source."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, 30), np.linspace(0, 1, 40),
                       indexing="ij")
    if curvy:
        lats = 55 + 3 * y + 0.3 * x + 0.05 * np.sin(3 * x)
        lons = 5 + 4 * x - 0.4 * y
    else:
        lats, lons = 55 + 3 * y, 5 + 4 * x
    olats, olons = np.meshgrid(np.linspace(54.9, 58.1, 45),
                               np.linspace(4.9, 9.1, 50), indexing="ij")
    plats = rng.uniform(54.8, 58.2, 60)
    plons = rng.uniform(4.8, 9.2, 60)
    return ((lats, lons, rng.uniform(0, 800, lats.shape).astype(np.float32)),
            (olats, olons, rng.uniform(0, 800, olats.shape).astype(
                np.float32)),
            (plats, plons, rng.uniform(0, 800, 60).astype(np.float32)))


def _objects(pkg, seed=0, curvy=False):
    src, tgt, pts = _grids(seed, curvy)
    return pkg.Grid(*src), pkg.Grid(*tgt), pkg.Points(*pts)


def _values(seed, shape, nan_frac=0.05):
    rng = np.random.default_rng(seed)
    v = rng.normal(280, 5, shape).astype(np.float32)
    v[rng.random(shape) < nan_frac] = np.nan
    return v


@pytest.mark.parametrize("curvy", [False, True])
@pytest.mark.parametrize("target", ["grid", "points"])
def test_bilinear_map_bit_for_bit(curvy, target):
    ja, jt, jp = _objects(gj, 1, curvy)
    ta, tt, tp = _objects(gt, 1, curvy)
    jq, tq = (jt, tt) if target == "grid" else (jp, tp)
    want = jbw.compute_bilinear_map(ja, jq.lats, jq.lons)
    got = tbw.compute_bilinear_map(ta, tq.lats, tq.lons)
    assert got.inside.any() and not got.inside.all()
    for name in ("p1", "p2", "p3", "p4", "nn", "s", "t", "inside"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_kdtree_queries_bit_for_bit():
    rng = np.random.default_rng(3)
    lats, lons = rng.uniform(55, 60, 500), rng.uniform(5, 12, 500)
    lats[7], lons[7] = lats[3], lons[3]  # an exact duplicate
    jt, tt = gj.KDTree(lats, lons), gt.KDTree(lats, lons)
    assert tt.size() == jt.size() == 500
    for name in ("get_lats", "get_lons", "get_x", "get_y", "get_z"):
        assert np.array_equal(getattr(tt, name)(), getattr(jt, name)())
    for qlat, qlon in zip(rng.uniform(55, 60, 20), rng.uniform(5, 12, 20)):
        for match in (True, False):
            assert tt.get_nearest_neighbour(qlat, qlon, match) == \
                jt.get_nearest_neighbour(qlat, qlon, match)
            assert np.array_equal(
                tt.get_closest_neighbours(qlat, qlon, 5, match),
                jt.get_closest_neighbours(qlat, qlon, 5, match))
            assert np.array_equal(
                tt.get_neighbours(qlat, qlon, 40000.0, match),
                jt.get_neighbours(qlat, qlon, 40000.0, match))
            ti, td = tt.get_neighbours_with_distance(qlat, qlon, 40000.0,
                                                     match)
            ji, jd = jt.get_neighbours_with_distance(qlat, qlon, 40000.0,
                                                     match)
            assert np.array_equal(ti, ji) and np.array_equal(td, jd)
            assert tt.get_num_neighbours(qlat, qlon, 40000.0, match) == \
                jt.get_num_neighbours(qlat, qlon, 40000.0, match)
    # the duplicate: include_match=False drops the exact match
    assert tt.get_nearest_neighbour(lats[3], lons[3], False) == \
        jt.get_nearest_neighbour(lats[3], lons[3], False)
    pts = [(gt.Point(60, 10), gt.Point(60.2, 10.3)),
           (gj.Point(60, 10), gj.Point(60.2, 10.3))]
    assert gt.KDTree.calc_distance(*pts[0]) == gj.KDTree.calc_distance(
        *pts[1])
    assert gt.KDTree_calc_straight_distance(*pts[0]) == \
        gj.KDTree_calc_straight_distance(*pts[1])
    for ctype in (gt.Geodetic, gt.Cartesian):
        args = (60.0, 10.0, 60.3, 10.5, int(ctype))
        assert gt.KDTree_calc_distance(*args) == gj.KDTree_calc_distance(
            *args)
        assert gt.KDTree_calc_distance_fast(*args) == \
            gj.KDTree_calc_distance_fast(*args)
    assert gt.KDTree_deg2rad(33.0) == gj.KDTree_deg2rad(33.0)
    assert gt.KDTree_rad2deg(0.7) == gj.KDTree_rad2deg(0.7)
    ct = gt.KDTree([0, 1000, 2000], [0, 1000, 2000], gt.Cartesian)
    cj = gj.KDTree([0, 1000, 2000], [0, 1000, 2000], gj.Cartesian)
    assert ct.get_coordinate_type() == cj.get_coordinate_type()
    assert np.array_equal(ct.get_neighbours(900, 900, 1500.0),
                          cj.get_neighbours(900, 900, 1500.0))


def _pair(pkg, form, seed):
    """(source, target, values) of package pkg for a dispatch form."""
    src, grid_t, pts = _objects(pkg, seed)
    psrc = pkg.Points(src.lats.ravel(), src.lons.ravel())
    gshape = src.lats.shape
    return {
        "grid-grid-2d": (src, grid_t, _values(seed, gshape)),
        "grid-grid-3d": (src, grid_t, _values(seed, (4,) + gshape)),
        "grid-points-2d": (src, pts, _values(seed, gshape)),
        "grid-points-3d": (src, pts, _values(seed, (3,) + gshape)),
        "points-points-1d": (psrc, pts, _values(seed, (psrc.size(),))),
        "points-points-2d": (psrc, pts, _values(seed, (2, psrc.size()))),
        "points-grid-1d": (psrc, grid_t, _values(seed, (psrc.size(),))),
        "points-grid-2d": (psrc, grid_t, _values(seed, (2, psrc.size()))),
    }[form]


FORMS = ["grid-grid-2d", "grid-grid-3d", "grid-points-2d", "grid-points-3d",
         "points-points-1d", "points-points-2d", "points-grid-1d",
         "points-grid-2d"]


@pytest.mark.parametrize("unpinned", [False, True])
@pytest.mark.parametrize("form", FORMS)
def test_nearest_equal(form, unpinned):
    want = gj.nearest(*_pair(gj, form, 4))
    fn = tapi.nearest if unpinned else gt.nearest
    got = fn(*_pair(gt, form, 4))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("unpinned", [False, True])
@pytest.mark.parametrize("form", [f for f in FORMS if f.startswith("grid")])
@pytest.mark.parametrize("curvy", [False, True])
def test_bilinear_matches(form, curvy, unpinned):
    def call(pkg, fn):
        src, tgt, pts = _objects(pkg, 5, curvy)
        _, _, vals = _pair(pkg, form, 5)
        return fn(src, tgt if "grid-grid" in form else pts, vals)

    want = call(gj, gj.bilinear)
    got = call(gt, tapi.bilinear if unpinned else gt.bilinear)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_bilinear_nan_corner_and_outside_fall_back_to_nearest():
    src, tgt, _ = _objects(gt, 6)
    vals = _values(6, src.lats.shape, nan_frac=0.3)
    got = gt.bilinear(src, tgt, vals)
    nn = gt.nearest(src, tgt, vals)
    m = tbw.compute_bilinear_map(src, tgt.lats, tgt.lons)
    flat = vals.reshape(-1)
    corners_ok = np.all([np.isfinite(flat[getattr(m, p)])
                         for p in ("p1", "p2", "p3", "p4")], axis=0)
    fall = (~m.inside | ~corners_ok).reshape(got.shape)
    assert fall.any() and (~fall).any()
    assert np.array_equal(got[fall], nn[fall], equal_nan=True)
    want = gj.bilinear(*_objects(gj, 6)[:2], vals)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("downscaler", ["Nearest", "Bilinear"])
def test_downscaling_dispatch(downscaler):
    src_j, tgt_j, _ = _objects(gj, 7)
    src_t, tgt_t, _ = _objects(gt, 7)
    vals = _values(7, (2,) + src_t.lats.shape)
    got = gt.downscaling(src_t, tgt_t, vals, getattr(gt, downscaler))
    want = gj.downscaling(src_j, tgt_j, vals, getattr(gj, downscaler))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="Invalid downscaler"):
        gt.downscaling(src_t, tgt_t, vals, 99)


@pytest.mark.parametrize("bad", ["shape", "ndim", "source"])
def test_errors_match(bad):
    def call(pkg, fn):
        src, tgt, _ = _objects(pkg, 8)
        vals = np.zeros(src.lats.shape, np.float32)
        if bad == "shape":
            return fn(src, tgt, vals[:, :-1])
        if bad == "ndim":
            return fn(src, tgt, vals[None, None])
        return fn(None, tgt, vals)

    for fn in ("nearest", "bilinear"):
        with pytest.raises(ValueError) as ej:
            call(gj, getattr(gj, fn))
        with pytest.raises(ValueError) as et:
            call(gt, getattr(gt, fn))
        assert str(et.value) == str(ej.value)


def test_empty_source_gives_missing():
    tgt = gt.Grid(*_grids(9)[1][:2])
    for fn in (gt.nearest, gt.bilinear):
        out = fn(gt.Grid(), tgt, np.zeros((0, 0), np.float32))
        assert out.shape == tgt.lats.shape and np.isnan(out).all()


def test_ops_match_jax():
    """ops/downscaling.py against gridpp_tpu's on (T, Y, X) values with
    NaN: the gather equal, the blend at the bars, and the ensemble
    probability for every comparison."""
    import jax.numpy as jnp
    src, tgt, _ = _objects(gt, 10, curvy=True)
    m = tbw.compute_bilinear_map(src, tgt.lats, tgt.lons)
    vals = _values(10, (3,) + src.lats.shape, nan_frac=0.1)
    args = (m.p1, m.p2, m.p3, m.p4, m.nn, m.s, m.t, m.inside)
    want = np.asarray(jops.bilinear_apply(jnp.asarray(vals),
                                          *map(jnp.asarray, args)))
    got = tops.bilinear_apply(torch.from_numpy(vals),
                              *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    idx = m.nn.reshape(tgt.lats.shape)
    assert np.array_equal(
        tops.gather_flat(torch.from_numpy(vals), torch.from_numpy(idx)),
        np.asarray(jops.gather_flat(jnp.asarray(vals), jnp.asarray(idx))),
        equal_nan=True)
    thr = np.full(tgt.lats.shape, 280.0, np.float32)
    for op in (gt.Lt, gt.Leq, gt.Gt, gt.Geq):
        got = tops.downscale_probability_apply(
            torch.from_numpy(vals), torch.from_numpy(idx),
            torch.from_numpy(thr), int(op)).numpy()
        want = np.asarray(jops.downscale_probability_apply(
            jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(thr), int(op)))
        assert np.array_equal(got, want, equal_nan=True)


def test_map_tensors_cached_per_target_and_device(monkeypatch):
    """The bilinear map is built once per target and its tensors are
    uploaded once per (target, device), in one entry per target beside the
    host map; another target builds its own, and a dropped target drops
    its entry."""
    builds = spy(monkeypatch, tapi, "compute_bilinear_map")
    src, tgt, pts = _objects(gt, 11)
    vals = _values(11, src.lats.shape)
    first = gt.bilinear(src, tgt, vals)
    cache = src.__dict__["_downscale_maps"]
    maps = cache[tgt][("bilinear", torch.device("cpu"))]
    assert gt.bilinear(src, tgt, vals + 1).shape == first.shape
    assert cache[tgt][("bilinear", torch.device("cpu"))] is maps
    assert len(builds) == 1
    gt.bilinear(src, pts, vals)
    assert len(builds) == 2
    # another device is another entry, built from the same host map
    meta = tapi._map_tensors(src, "bilinear", tgt, torch.device("meta"),
                             lambda: pytest.fail("the host map is cached"))
    assert all(t.device.type == "meta" for t in meta)
    assert ("bilinear", torch.device("meta")) in cache[tgt]
    assert len(builds) == 2
    gt.nearest(src, tgt, vals)
    assert ("nearest", torch.device("cpu")) in cache[tgt]
    n_before = len(cache)
    del pts
    gc.collect()
    assert len(cache) == n_before - 1


def test_unpinned_api_device_is_the_card_when_there_is_one(monkeypatch):
    """Unpinned, the API runs on the current card when torch's default
    device is the CPU and a card is present (gridpp_tpu's module functions
    run on jax's default backend); pinned or under host() on the CPU; under
    another default device there."""
    from gridpp_tpu_torch.api import _common
    assert _common.api_device() == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert _common.api_device() == torch.device("cuda", 0)
    assert not _common.on_host()
    assert _common.pin_host(_common.api_device)() == torch.device("cpu")
    with _common.host():
        assert _common.on_host()
        with torch.device("meta"):
            assert _common.api_device() == torch.device("cpu")
    with torch.device("meta"):
        assert _common.api_device() == torch.device("meta")
    assert _common.api_device() == torch.device("cuda", 0)
