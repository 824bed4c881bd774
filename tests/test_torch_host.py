"""The port's host precompute equals gridpp_tpu's bit for bit.

Grid.nearest_map, _resolved_fields, canonical_shortlist and
build_tile_tables are copies of numpy/C++ host code; on the same inputs
they must give identical arrays, or the selected observations (a discrete
decision) could differ between the packages.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_helpers import gj, gt, objects, problem  # noqa: E402

from gridpp_tpu.api.oi import _origin as j_origin  # noqa: E402
from gridpp_tpu.api.oi import _resolved_fields as j_resolved  # noqa: E402
from gridpp_tpu.ops.canonical import canonical_shortlist as j_sl  # noqa: E402
from gridpp_tpu.ops.oi_tiled import build_tile_tables as j_tables  # noqa: E402
from gridpp_tpu_torch.api.oi import _origin as t_origin  # noqa: E402
from gridpp_tpu_torch.api.oi import _resolved_fields as t_resolved  # noqa: E402
from gridpp_tpu_torch.ops.canonical import canonical_shortlist as t_sl  # noqa: E402
from gridpp_tpu_torch.ops.oi_tiled import build_tile_tables as t_tables  # noqa: E402

CASES = [
    # (seed, elevs and lafs, structure args: (kind, h, v, w))
    (0, False, ("BarnesStructure", 30000.0, 0.0, 0.0)),
    (1, True, ("BarnesStructure", 30000.0, 200.0, 0.5)),
    (2, True, ("SoarStructure", 25000.0, 300.0, 0.0)),
]


def _both(case):
    seed, elevs, (kind, h, v, w) = case
    prob = problem(seed, n=36, n_obs=70, elevs=elevs)
    out = []
    for pkg in (gj, gt):
        grid, pts, _ = objects(pkg, prob)
        out.append((grid, pts, getattr(pkg, kind)(h, v, w)))
    return out


def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_nearest_map(case):
    (gg, gp, _), (tg, tp, _) = _both(case)
    np.testing.assert_array_equal(gg.nearest_map(gp.lats, gp.lons),
                                  tg.nearest_map(tp.lats, tp.lons))


@pytest.mark.parametrize("case", CASES)
def test_resolved_fields(case):
    (gg, gp, gs), (tg, tp, ts) = _both(case)
    go = j_origin(gg.to_points())
    to = t_origin(tg.to_points())
    np.testing.assert_array_equal(go, to)
    _assert_dicts_equal(j_resolved(gp, gs, go), t_resolved(tp, ts, to))
    _assert_dicts_equal(j_resolved(gg.to_points(), gs, go),
                        t_resolved(tg.to_points(), ts, to))


@pytest.mark.parametrize("case", CASES)
def test_canonical_shortlist(case):
    (gg, gp, gs), (tg, tp, ts) = _both(case)
    a = j_sl(gg.to_points(), gp, gs, 16)
    b = t_sl(tg.to_points(), tp, ts, 16)
    for key in ("sel", "rho", "valid", "truncated"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)
    assert a.valid.any()


@pytest.mark.parametrize("case", CASES)
def test_build_tile_tables(case):
    (gg, gp, gs), (tg, tp, ts) = _both(case)
    sl = j_sl(gg.to_points(), gp, gs, 16)
    fields = j_resolved(gp, gs, j_origin(gg.to_points()))
    shape = tuple(gg.size())
    a = j_tables(sl.sel, sl.rho, sl.valid, fields, shape, th=8, tw=16)
    b = t_tables(sl.sel, sl.rho, sl.valid, fields, shape, th=8, tw=16)
    for key in ("tile_table", "table_mask", "local_idx", "rho", "valid",
                "tile_static"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)
    assert a.static_keys == b.static_keys
    assert (a.k_cap, a.c_cap, a.grid_pad) == (b.k_cap, b.c_cap, b.grid_pad)
