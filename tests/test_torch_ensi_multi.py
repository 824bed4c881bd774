"""gridpp_tpu_torch's ensi_multi (ops/oi_ensi_multi.py, MultiEnsiPipeline)
against gridpp_tpu on the CPU.

The same seeded numpy inputs go through both packages. Bars:
- `norm_anom`: atol 1e-5 (a 280 K member's f32 mean is good to ~1 ulp,
  3e-5, which the division by std ~5 and sqrt(E-1) scales to ~3e-6), and
  the zeroed rows equal;
- `_member_update`, `_utem_core` and the host kernels: atol 2e-4 (ebe,
  ebesc) or 5e-4 (utem), rtol 1e-4, on the ~280 K members, the bars of
  tests/test_oi_ensi_multi.py:341-386, with equal condition flags;
- MultiEnsiPipeline: atol 2e-4, rtol 1e-4 (5e-4 for utem) against
  gridpp_tpu's host parity API and its MultiEnsiPipeline
  (tests/test_oi_ensi_multi.py:341-386), and the result does not depend
  on the block size.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import ens_problem, gj, gt, objects, tensor  # noqa: E402
from gridpp_tpu.ops import oi_ensi_multi as jops  # noqa: E402
from gridpp_tpu_torch.api.oi import _origin, _resolved_fields  # noqa: E402
from gridpp_tpu_torch.ops import oi_ensi_multi as tops  # noqa: E402

ATOL = {"ebe": 2e-4, "ebesc": 2e-4, "utem": 5e-4}
RTOL = 1e-4


def test_norm_anom():
    rng = np.random.default_rng(0)
    arr = rng.normal(280, 5, (64, 6)).astype(np.float32)
    arr[3] = 281.0                 # std 0
    arr[4] = 281.0
    arr[4, 0] = 281.0001           # std below DEFAULT_MIN_STD
    got = tops.norm_anom(tensor(arr)).numpy()
    want = np.asarray(jops.norm_anom_jnp(jnp.asarray(arr)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3:5], 0.0)
    # population std: an unbiased std would be off by sqrt(6/5)
    np.testing.assert_allclose((got ** 2).sum(axis=1)[5:], 6 / 5, rtol=1e-4)


def _selection(seed, b=40, s=6, e=5):
    """Post-selection inputs with rows of every valid count, including a
    row with no valid obs."""
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, s + 1, b)
    n_valid[0] = 0
    sel_valid = np.arange(s)[None, :] < n_valid[:, None]
    lat = rng.uniform(55, 57, (b, s))
    lon = rng.uniform(5, 7, (b, s))
    pts = gt.Points(lat.ravel(), lon.ravel())
    origin = pts.xyz.mean(axis=0)
    st = gt.BarnesStructure(60000.0)
    fields = {key: v.reshape(b, s) for key, v in
              _resolved_fields(pts, st, origin).items()}
    return dict(
        rng=rng, fields=fields, sel_valid=sel_valid,
        l_rho=np.where(sel_valid, rng.uniform(0.05, 1, (b, s)),
                       0).astype(np.float32),
        l_r=np.full((b, s), 0.1, np.float32),
        background=rng.normal(280, 5, (b, e)).astype(np.float32),
        bratios=rng.uniform(0.5, 1.5, b).astype(np.float32))


def _agree(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("use_z", [False, True])
def test_member_update(use_z, allow):
    d = _selection(1 + use_z)
    rng, b, e = d["rng"], *d["background"].shape
    s = d["l_rho"].shape[1]
    l_innov = np.where(d["sel_valid"][:, :, None],
                       rng.normal(0, 2, (b, s, e)), 0).astype(np.float32)
    extra_np = {}
    if use_z:
        extra_np = dict(l_z=rng.normal(0, 0.5, (b, s, e)).astype(np.float32),
                        x_l=rng.normal(0, 0.5, (b, e)).astype(np.float32))
    args = (d["sel_valid"], d["l_rho"], d["l_r"], l_innov, d["background"],
            d["bratios"])
    got = tops._member_update(
        gt.BarnesStructure(60000.0),
        {key: tensor(v) for key, v in d["fields"].items()},
        *map(tensor, args), allow,
        **{key: tensor(v) for key, v in extra_np.items()})
    want = jops._member_update(
        gj.BarnesStructure(60000.0),
        {key: jnp.asarray(v) for key, v in d["fields"].items()},
        *map(jnp.asarray, args), allow,
        **{key: jnp.asarray(v) for key, v in extra_np.items()})
    _agree(got, want, ATOL["ebe"])
    np.testing.assert_array_equal(got[0].numpy(), d["background"][0])
    assert not np.allclose(got.numpy()[1:], d["background"][1:])


@pytest.mark.parametrize("allow", [True, False])
def test_utem_core(allow):
    d = _selection(3)
    rng, b, e = d["rng"], *d["background"].shape
    s = d["l_rho"].shape[1]
    bgc = (d["background"] + rng.normal(0, 1, (b, e))).astype(np.float32)
    args = (d["sel_valid"], d["l_rho"],
            rng.normal(280, 3, (b, s)).astype(np.float32), d["l_r"],
            rng.normal(280, 2, (b, s)).astype(np.float32),
            rng.normal(0, 2, (b, s, e)).astype(np.float32),
            rng.normal(0, 0.5, (b, s, e)).astype(np.float32),
            d["background"], bgc, d["bratios"])
    out, bad = tops._utem_core(*map(tensor, args), allow)
    want, want_bad = jops._utem_core(*map(jnp.asarray, args), allow)
    _agree(out, want, ATOL["utem"])
    np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))


def _kernel_inputs(seed=4, k=10):
    prob = ens_problem(seed, n=20, n_obs=40, e=5, span=2.0)
    grid, pts, _ = objects(gt, prob)
    st = gt.BarnesStructure(60000.0)
    bpoints = grid.to_points()
    origin = _origin(bpoints)
    p1 = _resolved_fields(bpoints, st, origin)
    of = _resolved_fields(pts, st, origin)
    d2 = sum((p1[c][:, None] - of[c][None, :]) ** 2 for c in "xyz")
    cand = np.argsort(d2, axis=1, kind="stable")[:, :k]
    bg = prob["background"].reshape(-1, 5)
    bgc = prob["background_corr"].reshape(-1, 5)
    pback, pbackc = prob["pback"], prob["pbackc"]
    y_hat = pback.mean(axis=1).astype(np.float32)
    common = dict(
        p1={key: v[:, None] for key, v in p1.items()},
        cf={key: v[cand] for key, v in of.items()},
        cand_valid=np.isfinite(prob["pobs"])[cand], bg=bg,
        bratios=np.full(bg.shape[0], 0.9, np.float32))
    per_obs = dict(
        x_l=np.array(jops.norm_anom_jnp(jnp.asarray(bgc))), bgc=bgc,
        obs=prob["pobs"][cand], pratios=prob["ratios"][cand],
        innov=(prob["pobs_e"] - pback)[cand],
        z_r=np.array(jops.norm_anom_jnp(jnp.asarray(pbackc)))[cand],
        y_anom=(pback - y_hat[:, None])[cand], y_hat=y_hat[cand])
    per_obs["y_corr"] = per_obs["z_r"]
    return common, per_obs


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("variant", ["ebe", "ebesc", "utem"])
def test_host_kernels(variant, allow):
    c, o = _kernel_inputs()
    names = {"ebe": ("x_l", "pratios", "innov", "z_r"),
             "ebesc": ("pratios", "innov"),
             "utem": ("bgc", "bratios", "obs", "pratios", "y_anom",
                      "y_corr", "y_hat")}[variant]
    o["bratios"] = c["bratios"]
    lead = (c["cand_valid"], c["bg"]) + (
        () if variant == "utem" else (c["bratios"],))
    args_np = lead + tuple(o[name] for name in names)
    got = getattr(tops, f"{variant}_kernel")(
        gt.BarnesStructure(60000.0),
        {key: tensor(v) for key, v in c["p1"].items()},
        {key: tensor(v) for key, v in c["cf"].items()},
        *map(tensor, args_np), 4, allow)
    j_args = [jnp.asarray(a) for a in args_np]
    if variant != "utem":  # gridpp_tpu's ebe/ebesc kernels take obs too
        j_args.insert(3 if variant == "ebesc" else 4, jnp.asarray(o["obs"]))
    want = getattr(jops, f"make_{variant}_kernel")(
        gj.BarnesStructure(60000.0), 4, allow)(
        {key: jnp.asarray(v) for key, v in c["p1"].items()},
        {key: jnp.asarray(v) for key, v in c["cf"].items()}, *j_args)
    if variant == "utem":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    _agree(got, want, ATOL[variant])
    assert not np.allclose(got.numpy(), c["bg"])


# -- MultiEnsiPipeline ------------------------------------------------------
def _mk(seed, nan_obs=0.0):
    """tests/test_oi_ensi_multi.py:310-327's problem: a 12 x 15 grid,
    25 obs, 5 members, BarnesStructure(60 km)."""
    rng = np.random.default_rng(seed)
    ny, nx, p, e = 12, 15, 25, 5
    lats, lons = np.meshgrid(np.linspace(55, 57, ny), np.linspace(5, 7, nx),
                             indexing="ij")
    plats = rng.uniform(55.05, 56.95, p)
    plons = rng.uniform(5.05, 6.95, p)
    bg = rng.normal(280, 5, (ny, nx, e)).astype(np.float32)
    bgc = (bg + rng.normal(0, 1, (ny, nx, e))).astype(np.float32)
    nn = gt.Grid(lats, lons).nearest_map(plats, plons)
    pback = bg.reshape(-1, e)[nn]
    pobs_e = (pback + rng.normal(0, 1, (p, e))).astype(np.float32)
    pobs_e[rng.random(p) < nan_obs] = np.nan
    return dict(lats=lats, lons=lons, plats=plats, plons=plons,
                pelev=np.zeros(p), plaf=np.zeros(p), gelev=None, glaf=None,
                bg=bg, bgc=bgc, pback=pback, pbackc=bgc.reshape(-1, e)[nn],
                pobs_e=pobs_e, pratios=np.full(p, 0.1, np.float32),
                bratios=rng.uniform(0.8, 1.2, (ny, nx)).astype(np.float32))


def _host(prob, variant, allow):
    grid, pts, _ = objects(gj, prob)
    st = gj.BarnesStructure(60000.0)
    if variant == "ebesc":
        return gj.optimal_interpolation_ensi_multi_ebesc(
            grid, prob["bratios"], prob["bg"], pts, prob["pobs_e"],
            prob["pratios"], prob["pback"], st, 10, allow)
    fn = getattr(gj, f"optimal_interpolation_ensi_multi_{variant}")
    pobs = prob["pobs_e"][:, 0].copy() if variant == "utem" \
        else prob["pobs_e"]
    return fn(grid, prob["bratios"], prob["bg"], prob["bgc"], pts, pobs,
              prob["pratios"], prob["pback"], prob["pbackc"], st, 10, allow)


def _cycle(pipe, prob, **kw):
    pobs = prob["pobs_e"][:, 0].copy() if pipe.variant == "utem" \
        else prob["pobs_e"]
    bgc = None if pipe.variant == "ebesc" else prob["bgc"]
    return pipe(prob["bg"], pobs, prob["pratios"], background_corr=bgc,
                **kw)


def _port(prob, variant, allow=True, **kw):
    g2, p2, _ = objects(gt, prob)
    return gt.MultiEnsiPipeline(g2, p2, gt.BarnesStructure(60000.0),
                                variant=variant, max_points=10,
                                allow_extrapolation=allow,
                                bratios=prob["bratios"], device="cpu", **kw)


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("variant", ["ebe", "ebesc", "utem"])
def test_multi_pipeline_matches_host_api(variant, allow):
    prob = _mk({"ebesc": 0, "ebe": 1, "utem": 2}[variant])
    got = _cycle(_port(prob, variant, allow), prob)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _host(prob, variant, allow),
                               atol=ATOL[variant], rtol=RTOL)


@pytest.mark.parametrize("variant", ["ebe", "ebesc", "utem"])
def test_multi_pipeline_matches_gridpp_tpu_pipeline(variant):
    prob = _mk(5)
    grid, pts, _ = objects(gj, prob)
    pj = gj.MultiEnsiPipeline(grid, pts, gj.BarnesStructure(60000.0),
                              variant=variant, max_points=10,
                              bratios=prob["bratios"])
    np.testing.assert_allclose(_cycle(_port(prob, variant), prob),
                               _cycle(pj, prob), atol=ATOL[variant],
                               rtol=RTOL)


@pytest.mark.parametrize("variant", ["ebesc", "utem"])
def test_multi_missing_obs_cycle(variant):
    """NaN obs this cycle: masked out of the shortlist, like the host API's
    validity screening (tests/test_oi_ensi_multi.py:372-387)."""
    prob = _mk(3, nan_obs=0.3)
    assert np.isnan(prob["pobs_e"][:, 0]).any()
    got = _cycle(_port(prob, variant, candidates=25), prob)
    np.testing.assert_allclose(got, _host(prob, variant, True),
                               atol=ATOL[variant], rtol=RTOL)
    assert not np.allclose(got, prob["bg"])


@pytest.mark.parametrize("variant", ["ebe", "utem"])
def test_multi_requires_background_corr(variant):
    prob = _mk(4)
    pipe = _port(prob, variant)
    pobs = prob["pobs_e"][:, 0].copy() if variant == "utem" \
        else prob["pobs_e"]
    with pytest.raises(ValueError, match="background_corr required"):
        pipe(prob["bg"], pobs, prob["pratios"])


def test_multi_constructor_errors():
    prob = _mk(4)
    g2, p2, st = objects(gt, prob)
    with pytest.raises(ValueError, match="variant"):
        gt.MultiEnsiPipeline(g2, p2, st, variant="nope", device="cpu")
    with pytest.raises(ValueError, match="Bratios"):
        gt.MultiEnsiPipeline(g2, p2, st, bratios=np.ones(7), device="cpu")
    pipe = gt.MultiEnsiPipeline(g2, p2, st, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        pipe.run_device(tensor(prob["bg"]).to("meta"),
                        tensor(prob["pobs_e"]), tensor(prob["pratios"]))


@pytest.mark.parametrize("variant", ["ebe", "ebesc", "utem"])
def test_multi_block_size_independent(variant):
    prob = _mk(6, nan_obs=0.2)
    a = _cycle(_port(prob, variant), prob)
    b = _cycle(_port(prob, variant, block=23), prob)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["ebe", "ebesc", "utem"])
def test_multi_pipeline_ignores_the_default_device(variant):
    """A pipeline on the CPU runs the same under another default device:
    the member update's pair correlations are made on the inputs' device,
    so a CPU pipeline under a CUDA default never mixes devices."""
    prob = _mk(7, nan_obs=0.2)
    pipe = _port(prob, variant)
    want = _cycle(pipe, prob)
    with torch.device("meta"):
        got = _cycle(pipe, prob)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["ebesc", "utem"])
def test_multi_serve_stream_matches_per_cycle_calls(variant):
    prob = _mk(7)
    pipe = _port(prob, variant)
    pobs = prob["pobs_e"][:, 0].copy() if variant == "utem" \
        else prob["pobs_e"]
    tail = () if variant == "ebesc" else (prob["bgc"],)
    cycles = [(prob["bg"] + np.float32(i), pobs, prob["pratios"]) + tail
              for i in range(4)]
    streamed = list(pipe.serve_stream(cycles))
    assert len(streamed) == len(cycles)
    for got, args in zip(streamed, cycles):
        np.testing.assert_array_equal(got, pipe(*args))
    assert not np.array_equal(streamed[0], streamed[1])


def test_utem_condition_count_is_a_device_scalar():
    prob = _mk(8)
    pipe = _port(prob, "utem")
    out, n_cond = pipe.run_device(
        tensor(prob["bg"]), tensor(prob["pobs_e"][:, 0].copy()),
        tensor(prob["pratios"]), tensor(prob["bgc"]))
    assert isinstance(n_cond, torch.Tensor) and n_cond.dim() == 0
    assert int(n_cond) == 0 and out.shape == prob["bg"].shape
