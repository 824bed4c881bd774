"""gridpp_tpu_torch.Pipeline against gridpp_tpu.Pipeline and the plain API.

The randomized networks of tests/test_pipeline_consistency.py (finite
elevations: with a NaN static obs field the reference's one-hot paging
breaks, ROADMAP F1). Bars: port vs gridpp_tpu max|d| <= 1e-4 unsmoothed
and <= 1e-3 with halfwidth 3 (the stencils sum in other orders); the
guarded general path equals the re-solve bit for bit; fast within 1e-3 of
general (:86); full shortlist within rtol 1e-4 / atol 1e-3 of
optimal_interpolation (:56).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, obs_values, objects, problem, tensor  # noqa: E402,E501

MAX_POINTS = 8
_PIPES = {}


def _pipes(halfwidth):
    """(prob, pobs, {kind: (gridpp_tpu Pipeline, port Pipeline)}) for
    the tiled and the flat path at `halfwidth`, built once per module."""
    if halfwidth not in _PIPES:
        prob = problem(0)
        grid, pts, sj = objects(gj, prob)
        g2, p2, st = objects(gt, prob)
        pipes = {}
        for kind, tiled in (("tiled", True), ("flat", False)):
            kw = dict(halfwidth=halfwidth, statistic=gj.Mean,
                      max_points=MAX_POINTS, tiled=tiled,
                      ratios=prob["ratios"])
            pipes[kind] = (gj.Pipeline(grid, pts, sj, **kw),
                           gt.Pipeline(g2, p2, st, device="cpu", **kw))
        _PIPES[halfwidth] = (prob, obs_values(prob, grid)[1], pipes)
    return _PIPES[halfwidth]


@pytest.mark.parametrize("halfwidth,tol", [(0, 1e-4), (3, 1e-3)])
@pytest.mark.parametrize("path", ["fast", "general", "resolve", "flat"])
def test_port_matches_gridpp_tpu(path, halfwidth, tol):
    prob, pobs, pipes = _pipes(halfwidth)
    bg = prob["background"]
    kind = "flat" if path == "flat" else "tiled"
    pj, pt = pipes[kind]
    if path == "fast":
        # the static-weights path serves an all-valid cycle
        pobs = np.where(np.isfinite(pobs), pobs, 280.0).astype(np.float32)
        kw = dict(path="fast", assume_valid=True)
    else:
        kw = dict(pratios=prob["ratios"],
                  path="general" if path == "flat" else path)
    want = np.asarray(pj.run_device(jnp.asarray(bg), jnp.asarray(pobs),
                                    **kw))
    got = pt.run_device(tensor(bg), tensor(pobs), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_port_geometry_equals_gridpp_tpu():
    _, _, pipes = _pipes(3)
    pj, pt = pipes["tiled"]
    state = pt.state()
    for key, v in pj._geom_dev.items():
        np.testing.assert_array_equal(state[key], np.asarray(v), err_msg=key)
    assert state["static_keys"] == list(pj._geom.static_keys)


def test_guarded_general_equals_resolve_bitwise():
    """Every cycle kind of the guarded cache (cold, hit, validity change,
    ratio change) equals the full re-solve bit for bit
    (tests/test_pipeline_consistency.py:286-316)."""
    prob = problem(7, nan_obs=0.0)
    grid, pts, st = objects(gt, prob)
    _, pobs = obs_values(prob, grid)
    ratios = prob["ratios"]
    pipe = gt.Pipeline(grid, pts, st, halfwidth=3, statistic=gt.Mean,
                       max_points=8, tiled=True, device="cpu")
    bg = tensor(prob["background"])

    def check(pobs_c, ratios_c):
        po = tensor(pobs_c)
        got = pipe.run_device(bg, po, ratios_c, path="general")
        want = pipe.run_device(bg, po, ratios_c, path="resolve")
        assert torch.equal(got, want)

    check(pobs, ratios)                      # cold cache
    check(pobs + 1.0, ratios)                # cache hit, new innovations
    pobs_gap = pobs.copy()
    pobs_gap[::3] = np.nan                   # validity change -> rebuild
    check(pobs_gap, ratios)
    check(pobs_gap - 0.5, ratios)            # cache hit on gapped network
    check(pobs, np.full_like(ratios, 0.05))  # ratios change -> rebuild
    check(pobs, ratios)                      # back to original ratios


def test_fast_path_matches_general_when_all_valid():
    prob = problem(7, nan_obs=0.0)
    grid, pts, st = objects(gt, prob)
    _, pobs = obs_values(prob, grid)
    pipe = gt.Pipeline(grid, pts, st, halfwidth=3, statistic=gt.Mean,
                       max_points=8, tiled=True, ratios=prob["ratios"],
                       device="cpu")
    bg, po = tensor(prob["background"]), tensor(pobs)
    fast = pipe.run_device(bg, po, path="fast", assume_valid=True)
    general = pipe.run_device(bg, po, prob["ratios"], path="general")
    np.testing.assert_allclose(fast.numpy(), general.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_shortlist_matches_plain_oi(seed):
    prob = problem(seed)
    grid, pts, sj = objects(gj, prob)
    pback, pobs = obs_values(prob, grid)
    n_obs = pts.size()
    plain = gj.optimal_interpolation(grid, prob["background"], pts, pobs,
                                     prob["ratios"], pback, sj, MAX_POINTS)
    g2, p2, st = objects(gt, prob)
    for tiled in (True, False):
        pipe = gt.Pipeline(g2, p2, st, halfwidth=0, max_points=MAX_POINTS,
                           tiled=tiled, candidates=n_obs, device="cpu")
        out = pipe(prob["background"], pobs, prob["ratios"])
        np.testing.assert_allclose(out, plain, rtol=1e-4, atol=1e-3)


def test_serve_stream_matches_per_cycle_calls():
    prob = problem(3, nan_obs=0.0)
    grid, pts, st = objects(gt, prob)
    _, pobs = obs_values(prob, grid)
    pipe = gt.Pipeline(grid, pts, st, halfwidth=2, max_points=6,
                       ratios=prob["ratios"], device="cpu")
    bg = prob["background"]
    cycles = [(bg + np.float32(i), pobs + np.float32(i)) for i in range(4)]
    streamed = list(pipe.serve_stream(cycles))
    assert len(streamed) == len(cycles)
    for got, args in zip(streamed, cycles):
        np.testing.assert_array_equal(got, pipe(*args))
    assert not np.array_equal(streamed[0], streamed[1])


def test_flat_pipeline_ratios_default_cycle():
    """A flat Pipeline built with ratios serves cycles without pratios
    (tests/test_pipeline_consistency.py:361-385)."""
    rng = np.random.default_rng(0)
    ny, nx, p = 16, 20, 12
    lats, lons = np.meshgrid(np.linspace(55, 56, ny), np.linspace(5, 6, nx),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    points = gt.Points(rng.uniform(55.05, 55.95, p),
                       rng.uniform(5.05, 5.95, p))
    ratios = np.full(p, 0.1, np.float32)
    pipe = gt.Pipeline(grid, points, gt.BarnesStructure(30000.0),
                       halfwidth=3, statistic=gt.Mean, max_points=5,
                       ratios=ratios, device="cpu")
    assert not pipe.tiled and pipe._static_w is None
    bg = tensor(rng.normal(280, 5, (ny, nx)).astype(np.float32))
    pobs = tensor(rng.normal(280, 5, p).astype(np.float32))
    out = pipe.run_device(bg, pobs)
    assert np.isfinite(out.numpy()).all()
    torch.testing.assert_close(out, pipe.run_device(bg, pobs,
                                                    path="general"))


def test_run_device_rejects_other_devices():
    prob, pobs, pipes = _pipes(0)
    pt = pipes["tiled"][1]
    bg = tensor(prob["background"])
    with pytest.raises(ValueError, match="runs on cpu"):
        pt.run_device(bg.to("meta"), tensor(pobs))
    with pytest.raises(ValueError, match="runs on cpu"):
        pt.run_device(bg, tensor(pobs), torch.ones(60, device="meta"),
                      path="general")
    with pytest.raises(TypeError):
        pt.run_device(prob["background"], pobs)
    with pytest.raises(ValueError, match="path"):
        pt.run_device(bg, tensor(pobs), path="cached")


_STAT_PIPES = {}


@pytest.mark.parametrize("stat,tol", [("Max", 1e-4), ("Std", 1e-3),
                                      ("Median", 1e-3)])
@pytest.mark.parametrize("path", ["general", "flat"])
def test_smoothing_statistics_match_gridpp_tpu(stat, tol, path):
    """Pipeline smoothed with Max (kernel K2 on the card), Std (K3) or
    Median (the brute force), halfwidth 3, against gridpp_tpu.Pipeline.

    Std runs on the anomaly of the problem (background and obs less
    280 K): on the 280 K field E[x^2] - E[x]^2 cancels about five of f32's
    seven digits in either package, so two correct implementations that
    sum in other orders (or, as XLA on the CPU does, fuse the last step
    into an FMA) differ by ~5e-3 there, beyond the bar."""
    prob = problem(0)
    if stat == "Std":
        prob["background"] = prob["background"] - np.float32(280.0)
    tiled = path != "flat"
    if (stat, tiled) not in _STAT_PIPES:
        grid, pts, sj = objects(gj, prob)
        g2, p2, st = objects(gt, prob)
        kw = dict(halfwidth=3, statistic=getattr(gj.Statistic, stat),
                  max_points=MAX_POINTS, tiled=tiled, ratios=prob["ratios"])
        _STAT_PIPES[stat, tiled] = (gj.Pipeline(grid, pts, sj, **kw),
                                    gt.Pipeline(g2, p2, st, device="cpu",
                                                **kw),
                                    obs_values(prob, grid)[1])
    pj, pt, pobs = _STAT_PIPES[stat, tiled]
    bg = prob["background"]
    kw = dict(pratios=prob["ratios"], path="general")
    want = np.asarray(pj.run_device(jnp.asarray(bg), jnp.asarray(pobs),
                                    **kw))
    got = pt.run_device(tensor(bg), tensor(pobs), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if tiled:
        assert torch.equal(torch.as_tensor(got), pt.run_device(
            tensor(bg), tensor(pobs), prob["ratios"], path="resolve"))


@pytest.mark.parametrize("stat,match", [
    ("Quantile", "requires a quantile level"),
    ("RandomChoice", "Cannot compute statistic")])
def test_statistics_without_a_stencil_raise_on_first_cycle(stat, match):
    """As in gridpp_tpu: the Pipeline builds, and its first cycle raises
    the ops layer's ValueError."""
    prob = problem(1, n=16, n_obs=12)
    g2, p2, st = objects(gt, prob)
    pipe = gt.Pipeline(g2, p2, st, halfwidth=2,
                       statistic=getattr(gt.Statistic, stat), max_points=4,
                       ratios=prob["ratios"], device="cpu")
    _, pobs = obs_values(prob, g2)
    with pytest.raises(ValueError, match=match):
        pipe(prob["background"], pobs)


@pytest.mark.parametrize("candidates", ["every obs", "default"])
def test_nan_obs_elevation_matches_plain_oi(candidates):
    """ROADMAP F1 pinned in the port: with one NaN obs elevation and a
    vertical structure scale, the tiled resolve and general paths and the
    flat path stay with gridpp_tpu.optimal_interpolation and with the
    port's own (the port pages with index gathers, so the NaN stays in its
    own candidate; gridpp_tpu's tiled path, which pages with one-hot
    einsums, does not), with a shortlist of every obs and at the default
    width, 2 x max_points."""
    prob = problem(5, n=60, n_obs=120, elevs=True)
    prob["pelev"] = prob["pelev"].copy()
    prob["pelev"][17] = np.nan
    grid, pts, sj = objects(gj, prob, gj.BarnesStructure(30000.0, 200.0))
    pback, pobs = obs_values(prob, grid)
    plain = gj.optimal_interpolation(grid, prob["background"], pts, pobs,
                                     prob["ratios"], pback, sj, MAX_POINTS)
    g2, p2, st = objects(gt, prob, gt.BarnesStructure(30000.0, 200.0))
    own = gt.optimal_interpolation(g2, prob["background"], p2, pobs,
                                   prob["ratios"], pback, st, MAX_POINTS)
    assert np.array_equal(own, plain, equal_nan=True)  # same native solver
    n_obs = p2.size()
    bg, po = tensor(prob["background"]), tensor(pobs)
    for tiled, paths in ((True, ("resolve", "general")), (False,
                                                          ("general",))):
        pipe = gt.Pipeline(g2, p2, st, halfwidth=0, max_points=MAX_POINTS,
                           tiled=tiled, device="cpu",
                           candidates=n_obs if candidates == "every obs"
                           else None)
        for path in paths:
            out = pipe.run_device(bg, po, prob["ratios"], path=path).numpy()
            for ref in (plain, own):
                np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3,
                                           err_msg=f"tiled={tiled} {path}")
