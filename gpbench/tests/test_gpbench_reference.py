"""The frozen reference held to gridpp_tpu_torch on the CPU at a tiny
size (the tests may import the port; the reference may not)."""
import numpy as np
import pytest
import torch

import gridpp_tpu_torch as gt
from gridpp_tpu_torch.ops.canonical import canonical_shortlist
from gridpp_tpu_torch.ops.neighbourhood import neighbourhood
from gpbench.harness import manifest
from gpbench.harness.traffic import Traffic
from gpbench.reference import geometry, stencil
from gpbench.tests import tiny

CPU = torch.device("cpu")


def _traffic(name, seed=5):
    c = tiny.cell(name)
    return c, Traffic(c.config, c.traffic, seed, CPU)


@pytest.mark.parametrize("h", [0, 1, 7])
def test_mean_matches_the_port(h):
    rng = np.random.default_rng(h)
    x = rng.normal(280, 5, (70, 90)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:20, :20] = np.nan                       # windows with no value
    ref = stencil.mean(torch.as_tensor(x), h).numpy()
    got = (neighbourhood(torch.as_tensor(x), h, gt.Statistic.Mean).numpy()
           if h else x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (np.isnan(got) == np.isnan(ref)).all()


def test_nearest_matches_the_port():
    _, t = _traffic("det2k_10k.static")
    grid = gt.Grid(t.lats, t.lons)
    np.testing.assert_array_equal(
        grid.nearest_map(t.plats, t.plons), t.nn)


def test_ranking_matches_the_canonical_shortlist():
    """The reference's order of the top stations is the port's, but
    where two rho lie within compare.TIE of each other."""
    c, t = _traffic("det2k_10k.static")
    k = int(c.config["candidates"])
    sl = canonical_shortlist(
        gt.Grid(t.lats, t.lons).to_points(),
        gt.Points(t.plats, t.plons, np.zeros(len(t.plats)),
                  np.zeros(len(t.plats))),
        gt.BarnesStructure(c.config["structure"]["h"]), k)
    sel, rho = geometry.ranked(t.lats, t.lons, t.plats, t.plons,
                               c.config["structure"]["h"], k + 1, CPU)
    sel, rho = sel.numpy(), rho.numpy()
    np.testing.assert_allclose(sl.rho, rho[:, :k], rtol=2e-5)
    gap = (rho[:, :-1] - rho[:, 1:]) / rho[:, :-1]
    clear = np.concatenate([gap[:, :1] > 1e-4,
                            (gap[:, 1:] > 1e-4) & (gap[:, :-1] > 1e-4)],
                           axis=1)[:, :k]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(sl.sel[clear], sel[:, :k][clear])


def test_first_valid_skips_and_flags():
    sel = torch.tensor([[3, 1, 4, 0], [2, 0, -1, -1], [1, 2, 3, 4]])
    rho = torch.tensor([[.9, .8, .7, .6], [.9, .5, 0, 0], [.9, .8, .7, .6]],
                       dtype=torch.float64)
    ok = torch.tensor([True, False, True, True, True])
    s, r, short = geometry.first_valid(sel, rho, ok, 2)
    assert s.tolist() == [[3, 4, 0], [2, 0, -1], [2, 3, 4]]
    assert r[0].tolist() == [.9, .7, .6]
    assert short.tolist() == [False, False, False]
    s, _, short = geometry.first_valid(sel, rho, ok, 3)
    assert short.tolist() == [True, False, True]


@pytest.mark.parametrize("name,bar", [("det2k_10k.static", 2e-4),
                                      ("det2k_10k.churn5", 2e-4),
                                      ("ensi2k_10k_m10.static", 2e-3)])
def test_reference_matches_the_port(name, bar):
    """The Check's reference against the pipeline on the same cycles, at
    the port's own bars (tests/test_torch_pipeline.py: 1e-4 unsmoothed,
    1e-3 smoothed; EnSI rtol 2e-4, atol 2e-3)."""
    c, t = _traffic(name)
    system = manifest.system(c.config)
    prog = system.build(c.config, t, CPU)
    check = system.Check(c.config, t, CPU)
    for i in range(3):
        out = prog.serve_stream([t.inputs(i)]).__next__()
        err = check.errors(i, out)
        assert float(err.max()) < bar, (i, float(err.max()))
