"""gridpp_tpu_torch's local_distribution_correction (api/ldc.py,
ops/ldc.py) against gridpp_tpu's on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- host route (the top-level, host-pinned function): both packages run the
  same native curve build (csrc ldc_host) on the same candidates and rho,
  equal bit for bit;
- device route run on the CPU (`on_host` patched to False in the port's
  api.ldc; gridpp_tpu's `_ldc_native` switched off, which gives its
  jitted ldc_block): rtol 2e-5, atol 2e-5 (tests/test_ldc.py:155). The
  test geometry keeps the stations off the exact localization radius,
  where gridpp_tpu's two routes themselves differ (the native route
  zeroes rho past the f32 radius);
- the device route's blocks give the same bits as one block, and
  api/oi._candidates past its exact query size (the ball query in blocks
  of rows, `_ball_fetch`, for max_points 0) gives the same candidate
  lists and results;
- ROADMAP F11: on a denser network the routes part past 2e-5 at a few
  ill-conditioned cells, gridpp_tpu's own two routes as the port's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, spy  # noqa: E402
import gridpp_tpu.api.ldc as jldc  # noqa: E402
import gridpp_tpu_torch.api.ldc as tldc  # noqa: E402
from gridpp_tpu_torch.api import oi as toi  # noqa: E402
from gridpp_tpu_torch.ops import ldc as tops  # noqa: E402

BAR = dict(rtol=2e-5, atol=2e-5)


def _problem(pkg, seed, n=14, num=50, nt=3, spacing=900.0, cartesian=True,
             dry=0.4):
    """Precipitation on an n x n grid with num stations and nt (obs,
    forecast) pairs each: gamma amounts, a share dry (exact zero ties), a
    few missing or negative pairs."""
    rng = np.random.default_rng(seed)
    if cartesian:
        y, x = np.meshgrid(np.arange(n) * spacing, np.arange(n) * spacing,
                           indexing="ij")
        grid = pkg.Grid(y, x, 0 * y, 0 * y, type=pkg.Cartesian)
        points = pkg.Points(rng.uniform(0, n * spacing, num),
                            rng.uniform(0, n * spacing, num), np.zeros(num),
                            np.zeros(num), pkg.Cartesian)
    else:
        lats, lons = np.meshgrid(np.linspace(59, 59.5, n),
                                 np.linspace(10, 10.8, n), indexing="ij")
        grid = pkg.Grid(lats, lons, rng.uniform(0, 400, lats.shape),
                        rng.uniform(0, 1, lats.shape))
        points = pkg.Points(rng.uniform(59, 59.5, num),
                            rng.uniform(10, 10.8, num),
                            rng.uniform(0, 400, num), rng.uniform(0, 1, num))
    background = rng.gamma(1.2, 2.5, (n, n)).astype(np.float32)
    background[rng.random((n, n)) < dry] = 0.0
    pobs = rng.gamma(1.2, 2.5, (nt, num)).astype(np.float32)
    pbg = rng.gamma(1.2, 2.5, (nt, num)).astype(np.float32)
    pobs[rng.random(pobs.shape) < dry] = 0.0
    pbg[rng.random(pbg.shape) < dry] = 0.0
    pobs[rng.random(pobs.shape) < 0.05] = np.nan
    pbg[rng.random(pbg.shape) < 0.03] = -1.0
    return grid, background, points, pobs, pbg


CASES = [dict(), dict(quantiles=(0.0, 1.0), min_points=0),
         dict(quantiles=(0.25, 0.75), min_points=10),
         dict(nt=1, num=30), dict(cartesian=False, structure="Barnes-elev"),
         dict(dry=0.8), dict(structure="Cressman")]


def _run(pkg, case, fn=None, seed=0):
    case = dict(case)
    minq, maxq = case.pop("quantiles", (0.1, 0.9))
    min_points = case.pop("min_points", 3)
    kind = case.pop("structure", "Barnes")
    grid, bg, pts, pobs, pbg = _problem(pkg, seed, **case)
    structure = {"Barnes": pkg.BarnesStructure(3000.0),
                 "Barnes-elev": pkg.BarnesStructure(6000.0, 200.0),
                 "Cressman": pkg.CressmanStructure(4500.0)}[kind]
    fn = fn or pkg.local_distribution_correction
    return fn(grid, bg, pts, pobs, pbg, structure, minq, maxq, min_points)


@pytest.mark.parametrize("case", CASES)
def test_ldc_host_route_bit_for_bit(case):
    got = _run(gt, case, seed=1)
    want = _run(gj, case, seed=1)
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)
    assert not np.array_equal(got, _problem(gt, 1, **{
        k: v for k, v in case.items()
        if k in ("nt", "num", "cartesian", "dry")})[1])


@pytest.mark.parametrize("case", CASES)
def test_ldc_device_route_matches_jax(monkeypatch, case):
    monkeypatch.setattr(jldc, "_ldc_native", lambda *a, **k: None)
    want = _run(gj, case, seed=2)
    monkeypatch.setattr(tldc, "on_host", lambda: False)
    native = spy(monkeypatch, tldc, "_ldc_native")
    blocks = spy(monkeypatch, tldc, "ldc_block")
    got = _run(gt, case, tldc.local_distribution_correction, seed=2)
    assert not native and len(blocks) == 1
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **BAR)


def test_ldc_device_blocks_give_one_block_bits(monkeypatch):
    monkeypatch.setattr(tldc, "on_host", lambda: False)
    whole = _run(gt, dict(), tldc.local_distribution_correction, seed=3)
    # seven gridpoints a block: 28 blocks of the 14 x 14 grid
    monkeypatch.setattr(tldc, "_BLOCK_BYTES", 1)
    monkeypatch.setattr(tldc, "block_rows", lambda k, nt: 7)
    blocks = spy(monkeypatch, tldc, "ldc_block")
    got = _run(gt, dict(), tldc.local_distribution_correction, seed=3)
    assert len(blocks) == 28
    assert np.array_equal(got, whole, equal_nan=True)


def test_ldc_block_rows_from_memory(monkeypatch):
    assert tldc.block_rows(150, 24) == (8 << 30) // (150 * 24 * 160)
    assert tldc.block_rows(1, 1) == toi._BLOCK
    monkeypatch.setattr(tldc, "_BLOCK_BYTES", 1)
    assert tldc.block_rows(150, 24) == 1


def test_ball_candidates_in_row_blocks(monkeypatch):
    """Past the exact query's size, api/oi._candidates with max_points 0
    runs the ball query in blocks of rows (`_ball_fetch`): the same
    lists, in the same (ascending observation) order, and so the same
    results on both routes."""
    grid, bg, pts, pobs, pbg = _problem(gt, 4)
    structure = gt.BarnesStructure(3000.0)
    bpoints = grid.to_points()
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    cand, mask = toi._candidates(bpoints, pts, loc, 0)
    host = gt.local_distribution_correction(grid, bg, pts, pobs, pbg,
                                            structure, 0.1, 0.9, 3)
    with monkeypatch.context() as m:
        m.setattr(tldc, "on_host", lambda: False)
        dev = tldc.local_distribution_correction(grid, bg, pts, pobs, pbg,
                                                 structure, 0.1, 0.9, 3)
    grid2, _, pts2, _, _ = _problem(gt, 4)
    bpoints2 = grid2.to_points()
    monkeypatch.setattr(toi, "_BALL_QUERY_MAX", 17)
    fetches = spy(monkeypatch, toi, "_ball_fetch")
    cand2, mask2 = toi._candidates(bpoints2, pts2, loc, 0)
    assert fetches == [1]
    assert np.array_equal(cand2, cand) and np.array_equal(mask2, mask)
    assert np.array_equal(gt.local_distribution_correction(
        grid2, bg, pts2, pobs, pbg, structure, 0.1, 0.9, 3), host)
    monkeypatch.setattr(tldc, "on_host", lambda: False)
    assert np.array_equal(tldc.local_distribution_correction(
        grid2, bg, pts2, pobs, pbg, structure, 0.1, 0.9, 3), dev,
        equal_nan=True)
    assert fetches == [1]  # the lists are cached on the grid's points


def test_ldc_block_op_matches_jax():
    """ops/ldc.ldc_block against gridpp_tpu's on random (B, M) rows with
    exact value ties, invalid pairs, empty rows and trims that keep
    nothing."""
    from gridpp_tpu.ops.ldc import ldc_block as jblock
    rng = np.random.default_rng(5)
    b, m = 64, 40
    obs = np.round(rng.gamma(1.0, 2.0, (b, m)), 1).astype(np.float32)
    fcst = np.round(rng.gamma(1.0, 2.0, (b, m)), 1).astype(np.float32)
    obs[rng.random((b, m)) < 0.3] = 0.0
    fcst[rng.random((b, m)) < 0.1] = np.nan
    rho = rng.uniform(0, 1, (b, m)).astype(np.float32)
    valid = rng.random((b, m)) < 0.8
    valid[:4] = False
    valid[4:8, 2:] = False
    bg = rng.gamma(1.0, 3.0, b).astype(np.float32)
    bg[::9] = 0.0
    bg[5] = np.nan
    for minq, maxq, mp in ((0.1, 0.9, 2), (0.0, 1.0, 0), (0.15, 0.19, 1),
                           (0.5, 0.5, 0)):
        want = np.asarray(jblock(bg, rho, valid, obs, fcst, minq, maxq, mp))
        got = tops.ldc_block(*(torch.from_numpy(a) for a in (
            bg, rho, valid, obs, fcst)), minq, maxq, mp).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **BAR)


@pytest.mark.parametrize("bad", ["grid", "pairs", "points"])
def test_ldc_errors_match(bad):
    def call(pkg):
        grid, bg, pts, pobs, pbg = _problem(pkg, 6)
        if bad == "grid":
            bg = bg[:, :-1]
        elif bad == "pairs":
            pbg = pbg[:, :-1]
        else:
            pobs, pbg = pobs[:, :-1], pbg[:, :-1]
        return pkg.local_distribution_correction(
            grid, bg, pts, pobs, pbg, pkg.BarnesStructure(3000.0), 0.1, 0.9)

    with pytest.raises(ValueError) as ej:
        call(gj)
    with pytest.raises(ValueError) as et:
        call(gt)
    assert str(et.value) == str(ej.value)


def test_ldc_routes_part_where_the_curve_is_ill_conditioned(monkeypatch):
    """ROADMAP F11: on a denser network (160 x 160 cells, 400 stations, 6
    pairs each, 60% dry), where q falls in a tiny quantile step (a pair of
    small rho between two curve points) the interpolation amplifies the
    last bits of the f32 sums, and any two routes that sum in other orders
    part past 2e-5 at a few cells: gridpp_tpu's own native and jitted
    routes, and the port's device and host routes, alike. The port's host
    route stays gridpp_tpu's bit for bit, and its device route parts from
    gridpp_tpu's jitted route on at most 0.1% of the cells."""
    out = {}
    for pkg in (gj, gt):
        grid, bg, pts, pobs, pbg = _problem(pkg, 0, n=160, num=400, nt=6,
                                            cartesian=False)
        args = (grid, bg, pts, pobs, pbg, pkg.BarnesStructure(5000.0), 0.1,
                0.9, 3)
        out[pkg, "host"] = pkg.local_distribution_correction(*args)
        with monkeypatch.context() as m:
            if pkg is gj:
                m.setattr(jldc, "_ldc_native", lambda *a, **k: None)
                out[pkg, "device"] = gj.local_distribution_correction(*args)
            else:
                m.setattr(tldc, "on_host", lambda: False)
                out[pkg, "device"] = tldc.local_distribution_correction(
                    *args)

    def past(a, b):
        return int((~np.isclose(a, b, equal_nan=True, **BAR)).sum())

    ref = past(out[gj, "host"], out[gj, "device"])
    assert ref > 0
    assert np.array_equal(out[gt, "host"], out[gj, "host"], equal_nan=True)
    assert past(out[gt, "device"], out[gt, "host"]) <= 2 * ref
    assert past(out[gt, "device"], out[gj, "device"]) <= 0.001 * 160 * 160


def test_ball_candidates_rows_off_the_ball_take_its_list(monkeypatch):
    """A row whose k-nearest fetch misses an observation of its ball query
    (a distance within an ulp of the radius) takes the ball query's own
    list."""
    grid, _, pts, _, _ = _problem(gt, 7)
    structure = gt.BarnesStructure(3000.0)
    bpoints = grid.to_points()
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    want = toi._candidates(bpoints, pts, loc, 0)
    tree = pts.index.tree

    class Fetch:
        """The tree, its k-nearest fetch losing row 5's farthest hit."""

        def query_ball_point(self, *a, **k):
            return tree.query_ball_point(*a, **k)

        def query(self, *a, **k):
            dist, idx = tree.query(*a, **k)
            hits = np.nonzero(np.isfinite(dist[5]))[0]
            dist[5, hits[-1]] = np.inf
            return dist, idx

    grid2, _, pts2, _, _ = _problem(gt, 7)
    monkeypatch.setattr(type(pts2.index), "tree",
                        property(lambda self: Fetch()))
    monkeypatch.setattr(toi, "_BALL_QUERY_MAX", 50)
    got = toi._candidates(grid2.to_points(), pts2, loc, 0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
