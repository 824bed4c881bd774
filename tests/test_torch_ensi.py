"""gridpp_tpu_torch's EnSI (ops/oi_ensi.py, EnsiPipeline) against
gridpp_tpu on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- `_inv_sqrt_ns`: within 5e-5 (relative to the largest entry) of
  numpy.linalg.eigh in float64 — the f32 iteration's error is ~kappa * eps
  (kappa <= ~60 here) — and within 1e-4 of gridpp_tpu's, which is as far
  from the exact root (the products sum in another order);
- `_ensi_update` and the three sweeps: max|d| <= 2e-3 on the ~280 K
  members, the bar of gridpp_tpu's pipeline tests, with equal condition
  flags and the rows without a valid obs (or with a NaN background)
  returned as they came;
- EnsiPipeline: rtol 2e-4, atol 2e-3 against gridpp_tpu.EnsiPipeline and
  gridpp_tpu.optimal_interpolation_ensi
  (tests/test_pipeline_consistency.py:228, :283); the all-valid fast path
  equals the general path bit for bit (:231-253), and the result does not
  depend on the block size.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import ens_problem, gj, gt, objects, tensor  # noqa: E402
from gridpp_tpu.ops import oi_ensi as jops  # noqa: E402
from gridpp_tpu_torch.api.oi import _origin, _resolved_fields  # noqa: E402
from gridpp_tpu_torch.ops import oi_ensi as tops  # noqa: E402
from gridpp_tpu_torch.ops.canonical import canonical_shortlist  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-3)  # tests/test_pipeline_consistency.py:228
OP_ATOL = 2e-3


def _spd(seed, b, e, s=10):
    """Pinv-like SPD matrices: Y^T Rinv Y + (E-1) I."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 3, (b, s, e))
    rinv = rng.uniform(0, 2, (b, s))
    return (np.einsum("bse,bs,bsf->bef", y, rinv, y)
            + (e - 1) * np.eye(e)).astype(np.float32)


@pytest.mark.parametrize("e", [4, 6, 10])
def test_inv_sqrt_ns(e):
    pinv = _spd(e, 64, e)
    z, c = tops._inv_sqrt_ns(tensor(pinv))
    got = z.numpy() / np.sqrt(c.numpy())[:, None, None]
    w, v = np.linalg.eigh(pinv.astype(np.float64))
    exact = np.einsum("bij,bj,bkj->bik", v, w ** -0.5, v)
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() / scale < 5e-5
    zj, cj = jops._inv_sqrt_ns(jnp.asarray(pinv))
    want = np.moveaxis(np.asarray(zj), 2, 0) / np.sqrt(np.asarray(cj))[
        :, None, None]
    assert np.abs(got - want).max() / scale < 1e-4
    assert torch.equal(z, z.transpose(1, 2))  # symmetrised on the way out


def _selection(seed, b=48, s=6, e=5):
    """Post-selection inputs of _ensi_update with every case the tail
    meets: rows with fewer valid obs than s (the no-extrapolation quirk's
    stride), a row with none, and a row with a NaN background (a padded
    row of the reference's blocks)."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, s + 1, b)
    n_valid[0] = 0
    n_valid[2] = 2
    sel_valid = np.arange(s)[None, :] < n_valid[:, None]
    l_rho = np.where(sel_valid, rng.uniform(0.05, 1, (b, s)),
                     0).astype(np.float32)
    l_obs = rng.normal(280, 3, (b, s)).astype(np.float32)
    l_sig = rng.uniform(0.5, 2, (b, s)).astype(np.float32)
    l_y = rng.normal(0, 2, (b, s, e)).astype(np.float32)
    l_yhat = rng.normal(280, 2, (b, s)).astype(np.float32)
    background = rng.normal(280, 5, (b, e)).astype(np.float32)
    background[1] = np.nan
    return sel_valid, l_rho, l_obs, l_sig, l_y, l_yhat, background


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_ensi_update(seed, allow):
    args = _selection(seed)
    out, bad = tops._ensi_update(*map(tensor, args), allow)
    want, want_bad = jops._ensi_update(None, *map(jnp.asarray, args), allow)
    out = out.numpy()
    np.testing.assert_allclose(out, np.asarray(want), rtol=0,
                               atol=OP_ATOL)
    np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))
    background = args[-1]
    np.testing.assert_array_equal(out[0], background[0])  # no valid obs
    assert np.isnan(out[1]).all()  # NaN background row untouched
    assert np.isfinite(np.delete(out, 1, axis=0)).all()
    assert not np.allclose(out[2:], background[2:])  # the update moved


def test_no_extrapolation_reads_y_with_the_valid_count_stride():
    """A row with 2 valid obs of 6 slots: the clamp reads lY[e] with the
    valid count as the stride (oi_ensi.cpp:520-537), so garbage in the
    invalid slots must not change the result."""
    args = list(_selection(3))
    l_y = args[4].copy()
    l_y[2, 2:] = 1e4  # invalid slots of row 2
    out_a, _ = tops._ensi_update(*map(tensor, args), False)
    args[4] = l_y
    out_b, _ = tops._ensi_update(*map(tensor, args), False)
    assert torch.equal(out_a[2], out_b[2])
    want, _ = jops._ensi_update(None, *map(jnp.asarray, args), False)
    np.testing.assert_allclose(out_b[2].numpy(), np.asarray(want)[2],
                               rtol=0, atol=OP_ATOL)


def _ensi_float64(sel_valid, l_rho, l_obs, l_sig, l_y, l_yhat, background):
    """EnSI as oi_ensi.cpp:296-444 computes it, in float64 with eigh:
    Pinv = Y^T Rinv Y + (E-1) I, W = sqrt((E-1) Pinv^-1), w = Pinv^-1 Y^T
    Rinv innov, analysis_e = mean + (W x)_e + x . w."""
    e = background.shape[1]
    rinv = np.where(sel_valid, l_rho / l_sig.astype(np.float64) ** 2, 0.0)
    innov = np.where(sel_valid, l_obs.astype(np.float64) - l_yhat, 0.0)
    y = l_y.astype(np.float64)
    lam, v = np.linalg.eigh(np.einsum("bse,bs,bsf->bef", y, rinv, y)
                            + (e - 1) * np.eye(e))
    w_mat = np.einsum("bij,bj,bkj->bik", v, np.sqrt((e - 1) / lam), v)
    w = np.einsum("bij,bj,bkj,bk->bi", v, 1 / lam, v,
                  np.einsum("bse,bs,bs->be", y, rinv, innov))
    mean = background.astype(np.float64).mean(axis=1, keepdims=True)
    x = background - mean
    return mean + np.einsum("bke,bk->be", w_mat, x) \
        + (x * w).sum(axis=1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_ensi_update_matches_float64_eigh(seed):
    """ROADMAP F6: with innovations large against the weights (obs ~10 K
    off the members, 10 obs, 10 members), gridpp_tpu's w = z z C innov / c
    keeps ~3 digits in f32 (6e-3 to 1.3e-2 K off float64 here); the port's
    refinement step against Pinv keeps it within 1e-3 K."""
    rng = np.random.default_rng(seed)
    b, s, e = 4000, 10, 10
    args = (np.ones((b, s), bool),
            rng.uniform(0.3, 1, (b, s)).astype(np.float32),
            rng.normal(290, 5, (b, s)).astype(np.float32),
            np.full((b, s), 1.5, np.float32),
            rng.normal(0, 5, (b, s, e)).astype(np.float32),
            rng.normal(280, 1, (b, s)).astype(np.float32),
            rng.normal(280, 5, (b, e)).astype(np.float32))
    exact = _ensi_float64(*args)
    out, _ = tops._ensi_update(*map(tensor, args), True)
    assert np.abs(out.numpy() - exact).max() < 1e-3
    ref, _ = jops._ensi_update(None, *map(jnp.asarray, args), True)
    assert np.abs(np.asarray(ref) - exact).max() > 3e-3


def _sweep_inputs(seed=5, k=10):
    prob = ens_problem(seed, n=24, n_obs=40, e=5, span=2.0)
    grid, pts, _ = objects(gt, prob)
    st = gt.BarnesStructure(30000.0)
    bpoints = grid.to_points()
    origin = _origin(bpoints)
    p1 = _resolved_fields(bpoints, st, origin)
    of = _resolved_fields(pts, st, origin)
    bg = prob["background"].reshape(-1, 5)
    pback = prob["pback"]
    y_hat = pback.mean(axis=1).astype(np.float32)
    y_anom = (pback - y_hat[:, None]).astype(np.float32)
    d2 = sum((p1[c][:, None] - of[c][None, :]) ** 2 for c in "xyz")
    cand = np.argsort(d2, axis=1, kind="stable")[:, :k]
    cand_valid = np.isfinite(prob["pobs"])[cand]
    return dict(prob=prob, pts=pts, bpoints=bpoints, st=st, p1=p1, of=of,
                bg=bg, y_hat=y_hat, y_anom=y_anom, cand=cand,
                cand_valid=cand_valid)


def _check_sweep(got, want, background):
    out, bad = got
    want_out, want_bad = (np.asarray(w) for w in want)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=OP_ATOL)
    np.testing.assert_array_equal(bad.numpy(), want_bad)
    assert not np.allclose(out.numpy(), background)


@pytest.mark.parametrize("allow", [True, False])
def test_ensi_kernel(allow):
    d = _sweep_inputs()
    cand, obs = d["cand"], d["prob"]["pobs"]
    p1 = {key: v[:, None] for key, v in d["p1"].items()}
    cf = {key: v[cand] for key, v in d["of"].items()}
    args = (d["cand_valid"], d["bg"], obs[cand], d["prob"]["psig"][cand],
            d["y_anom"][cand], d["y_hat"][cand])
    got = tops.ensi_kernel(
        d["st"], {key: tensor(v) for key, v in p1.items()},
        {key: tensor(v) for key, v in cf.items()}, *map(tensor, args), 4,
        allow)
    want = jops.make_ensi_kernel(gj.BarnesStructure(30000.0), 4, allow)(
        {key: jnp.asarray(v) for key, v in p1.items()},
        {key: jnp.asarray(v) for key, v in cf.items()},
        *map(jnp.asarray, args))
    _check_sweep(got, want, d["bg"])


@pytest.mark.parametrize("allow", [True, False])
def test_ensi_shortlist_sweep(allow):
    d = _sweep_inputs()
    sl = canonical_shortlist(d["bpoints"], d["pts"], d["st"], 10)
    prob = d["prob"]
    args = (sl.sel, sl.rho, sl.valid, d["bg"], prob["pobs"], prob["psig"],
            d["y_anom"], d["y_hat"])
    got = tops.ensi_shortlist_sweep(*map(tensor, args), 4, allow, block=97)
    want = jops.make_ensi_shortlist_sweep(
        gj.BarnesStructure(30000.0), 4, allow, 64)(*map(jnp.asarray, args))
    _check_sweep(got, want, d["bg"])


@pytest.mark.parametrize("allow", [True, False])
def test_ensi_dense_sweep(allow):
    d = _sweep_inputs()
    prob = d["prob"]
    keep = np.isfinite(prob["pobs"])
    of = {key: v[keep] for key, v in d["of"].items()}
    args = (d["bg"], prob["pobs"][keep], prob["psig"][keep],
            d["y_anom"][keep], d["y_hat"][keep])
    got = tops.ensi_dense_sweep(
        d["st"], {key: tensor(v) for key, v in d["p1"].items()},
        {key: tensor(v) for key, v in of.items()}, *map(tensor, args), 4,
        allow, block=100)
    want = jops.make_ensi_dense_sweep(gj.BarnesStructure(30000.0), 4, allow,
                                      128)(
        {key: jnp.asarray(v) for key, v in d["p1"].items()},
        {key: jnp.asarray(v) for key, v in of.items()},
        *map(jnp.asarray, args))
    _check_sweep(got, want, d["bg"])


# -- EnsiPipeline ---------------------------------------------------------
_PIPES = {}


def _pipes(halfwidth, allow=True, statistic="Mean", seed=100):
    """(prob, gridpp_tpu EnsiPipeline, port EnsiPipeline), full-depth
    shortlist (candidates = every obs), built once per module."""
    key = (halfwidth, allow, statistic, seed)
    if key not in _PIPES:
        prob = ens_problem(seed)
        if statistic == "Std":
            # E[x^2] - E[x]^2 of the 280 K field cancels most of f32's
            # digits in either package (tests/test_torch_pipeline.py)
            prob["background"] = prob["background"] - np.float32(280.0)
            prob["pobs"] = prob["pobs"] - np.float32(280.0)
        kw = dict(halfwidth=halfwidth, max_points=5,
                  statistic=getattr(gj.Statistic, statistic),
                  allow_extrapolation=allow, candidates=prob["pobs"].size)
        grid, pts, _ = objects(gj, prob)
        g2, p2, _ = objects(gt, prob)
        _PIPES[key] = (prob, gj.EnsiPipeline(grid, pts,
                                             gj.BarnesStructure(30000.0),
                                             **kw),
                       gt.EnsiPipeline(g2, p2, gt.BarnesStructure(30000.0),
                                       device="cpu", **kw))
    return _PIPES[key]


def _host_ensi(prob, halfwidth, allow):
    """gridpp_tpu.optimal_interpolation_ensi on the background the pipeline
    sees: each member smoothed with gridpp_tpu.neighbourhood Mean."""
    grid, pts, sj = objects(gj, prob)
    bg = prob["background"]
    e = bg.shape[2]
    if halfwidth:
        bg = np.stack([gj.neighbourhood(bg[:, :, k], halfwidth, gj.Mean)
                       for k in range(e)], axis=-1).astype(np.float32)
    pback = bg.reshape(-1, e)[grid.nearest_map(pts.lats, pts.lons)]
    return gj.optimal_interpolation_ensi(
        grid, bg, pts, prob["pobs"], prob["psig"], pback, sj, 5, allow)


@pytest.mark.parametrize("halfwidth,ref,allow", [
    (0, "pipeline", True), (2, "pipeline", True), (0, "host", True),
    (2, "host", True), (0, "pipeline", False), (2, "host", False)])
def test_ensi_pipeline_matches_gridpp_tpu(halfwidth, ref, allow):
    """20% of the obs missing; with and without Mean smoothing (h=2)."""
    prob, pj, pt = _pipes(halfwidth, allow)
    assert np.isnan(prob["pobs"]).any()
    got = pt(prob["background"], prob["pobs"], prob["psig"])
    if ref == "pipeline":
        want = pj(prob["background"], prob["pobs"], prob["psig"])
    else:
        want = _host_ensi(prob, halfwidth, allow)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stat", ["Max", "Std", "Median"])
def test_ensi_pipeline_smoothing_statistics(stat):
    """Max through the member stencil's plain version (K5 on the card), Std
    through K3's (batched over the members), Median the brute force."""
    prob, pj, pt = _pipes(2, statistic=stat)
    args = (prob["background"], prob["pobs"], prob["psig"])
    np.testing.assert_allclose(pt(*args), pj(*args), **TOL)


@pytest.mark.parametrize("stat,match", [
    ("Quantile", "requires a quantile level"),
    ("RandomChoice", "Cannot compute statistic")])
def test_ensi_statistics_without_a_stencil_raise_on_first_cycle(stat,
                                                                 match):
    prob = ens_problem(1, n=16, n_obs=12, e=4)
    g2, p2, st = objects(gt, prob)
    pipe = gt.EnsiPipeline(g2, p2, st, halfwidth=2,
                           statistic=getattr(gt.Statistic, stat),
                           max_points=4, device="cpu")
    with pytest.raises(ValueError, match=match):
        pipe(prob["background"], prob["pobs"], prob["psig"])


def _all_valid(prob):
    return np.where(np.isfinite(prob["pobs"]), prob["pobs"],
                    np.float32(281.0)).astype(np.float32)


@pytest.mark.parametrize("halfwidth", [0, 2])
def test_ensi_fast_equals_general_bitwise(halfwidth):
    prob, _, pt = _pipes(halfwidth, seed=42)
    bg, po, ps = (tensor(prob["background"]), tensor(_all_valid(prob)),
                  tensor(prob["psig"]))
    general, n_gen = pt.run_device(bg, po, ps)
    fast, n_fast = pt.run_device(bg, po, ps, assume_valid=True)
    assert torch.equal(general, fast)
    assert isinstance(n_fast, torch.Tensor) and int(n_fast) == 0
    assert int(n_gen) == 0


def test_ensi_shortlist_state_equals_gridpp_tpu():
    """The port keeps the shortlist as (N, K) rows; gridpp_tpu pads and
    blocks it (nb, block, K). Equal element for element on the N rows,
    the fast path's prefix too."""
    prob, pj, pt = _pipes(0)
    n = prob["background"].shape[0] * prob["background"].shape[1]
    for cand_j, cand_t in ((pj._cand, pt._cand),
                           (pj._cand_fast, pt._cand_fast)):
        for a, b in zip(cand_j, cand_t):
            a = np.asarray(a)
            np.testing.assert_array_equal(
                a.reshape(-1, a.shape[-1])[:n], b.numpy())


@pytest.mark.parametrize("assume_valid", [False, True])
def test_ensi_block_size_independent(assume_valid):
    prob = ens_problem(7, nan_obs=0.0 if assume_valid else 0.2)
    g2, p2, st = objects(gt, prob)
    kw = dict(halfwidth=1, max_points=5, device="cpu")
    whole = gt.EnsiPipeline(g2, p2, st, **kw)
    blocked = gt.EnsiPipeline(g2, p2, st, block=37, **kw)
    args = (tensor(prob["background"]), tensor(prob["pobs"]),
            tensor(prob["psig"]))
    a = whole.run_device(*args, assume_valid=assume_valid)
    b = blocked.run_device(*args, assume_valid=assume_valid)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ensi_serve_stream_matches_per_cycle_calls():
    prob = ens_problem(3, nan_obs=0.0, e=3)
    g2, p2, st = objects(gt, prob)
    pipe = gt.EnsiPipeline(g2, p2, st, max_points=6, device="cpu")
    cycles = [(prob["background"] + np.float32(i), prob["pobs"],
               prob["psig"]) for i in range(4)]
    streamed = list(pipe.serve_stream(cycles))
    assert len(streamed) == len(cycles)
    for got, args in zip(streamed, cycles):
        np.testing.assert_array_equal(got, pipe(*args))
    assert not np.array_equal(streamed[0], streamed[1])


def test_ensi_run_device_rejects_other_devices():
    prob, _, pt = _pipes(0)
    bg, po, ps = (tensor(prob["background"]), tensor(prob["pobs"]),
                  tensor(prob["psig"]))
    with pytest.raises(ValueError, match="runs on cpu"):
        pt.run_device(bg.to("meta"), po, ps)
    with pytest.raises(ValueError, match="runs on cpu"):
        pt.run_device(bg, po, ps.to("meta"))
    with pytest.raises(TypeError):
        pt.run_device(prob["background"], po, ps)
    with pytest.raises(ValueError, match=r"\(Y, X, E\)"):
        pt.run_device(bg[:, :, 0], po, ps)
