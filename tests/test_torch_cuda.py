"""Kernels K1-K5 and the serving pipelines on a CUDA card (skipped without
one).

Each kernel is held to its plain PyTorch version on the same card, at the
bars of tests/test_pallas_stencil.py: K1 and K5's Mean/Sum/Count rtol 1e-5,
atol 1e-4 (:36-38, :199); K2 and K5's Min/Max bit for bit (order-free);
K3 rtol 2e-5, atol 2e-3 (:220), on one plane and on EnSI's ten; K4 (the
wide route's running and prefix counts) bit for bit, NaN positions
included, ties (:70-85) and the lane-width boundaries too, within 1e-5 of
it past 2^24 cells a window, and a window past its int32 guard raises.
Every kernel's launch counter moves by one per launch. The EnSI
transform's kernel (csrc/ensi_transform.cu) is held to the plain chain on
the CPU within 2e-3 (tests/test_torch_ensi.py) at 3 to 32 members and 1 to
20 slots, with and without extrapolation, cond_bad equal, and within 1e-3
K of float64 eigh (ROADMAP F6); EnsiPipeline's result does not depend on
the block, and its serving stream launches it once a block and no cuBLAS
product. The pipelines on the card agree with
their CPU runs (the plain versions): Pipeline within 1e-3, EnsiPipeline
and utem within 2e-3, ebe and ebesc within 1e-3; an EnSI cycle smoothed
with Mean launches K5 once. The six OI API functions on their device route
(the module function under the card as default device) stay within 1e-2
of their host route. The downscale -> gradient -> calibrate calls on their
device route match their host route (nearest equal; bilinear, MinMax and
the curves rtol 1e-6, atol 1e-4), reuse the map's tensors, make no CPU
tensor before their final copy, and calc_gradient's LinearRegression is
five K1 launches whose gradient is within K1's bars carried through the
regression (ROADMAP F9). A tiled Pipeline's captured cycles replay with no
host synchronisation (set_sync_debug_mode "error"), and at 2000 x 2000
with 10,000 obs its general graph equals the re-solve bit for bit on every
cycle of a validity/ratios sequence, rebuilding exactly where they change.
Under a profiler session the serving stream records gridpp_tpu_torch.
tracing's spans and counts on the card, its waits and the graph capture
included.

This file imports no jax, so it also runs on a machine with the card and
no JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch.api.gradients import lr_bar  # noqa: E402
from gridpp_tpu_torch.ops import neighbourhood as tops  # noqa: E402
from gridpp_tpu_torch.ops import oi_ensi  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_pallas_stencil.py:36-38
VAR_TOL = dict(rtol=2e-5, atol=2e-3)  # :220
SHAPES = [((40, 60), 3), ((17, 250), 7), ((300, 129), 1), ((31, 31), 0),
          ((256, 129), 7), ((160, 128), 3), ((256, 300), 7), ((12, 9), 20),
          ((3, 256, 300), 7), ((2000, 2000), 7)]
# statistic -> (kernel wrapper, bar)
KERNEL_OF = {int(gt.Mean): (stencil.neighbourhood_mean_cuda, TOL),
             int(gt.Sum): (stencil.neighbourhood_mean_cuda, TOL),
             int(gt.Count): (stencil.neighbourhood_mean_cuda, TOL),
             int(gt.Min): (stencil.neighbourhood_minmax_cuda, None),
             int(gt.Max): (stencil.neighbourhood_minmax_cuda, None),
             int(gt.Std): (stencil.neighbourhood_var_cuda, VAR_TOL),
             int(gt.Variance): (stencil.neighbourhood_var_cuda, VAR_TOL)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _field_280(shape, seed=0, nan_frac=0.1):
    """The benchmark's background, normal(280, 5), with a share missing.
    Past h=80 a window sums thousands of cells: on a zero-mean field the
    sum cancels far below the f32 rounding of its partial sums, so the wide
    cases use this field (and its anomaly for Std/Variance, whose E[x^2] -
    E[x]^2 of a 280 K field cancels most of f32's digits)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(280, 5, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _assert_matches(got, want, tol):
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if tol is None:
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("stat", list(KERNEL_OF))
@pytest.mark.parametrize("shape,h", SHAPES)
def test_kernel_matches_plain(dev, stat, shape, h):
    """ops.neighbourhood on the card (K1, K2 or K3) against the same op on
    the same values, on the card, through the plain dispatch."""
    x = torch.as_tensor(_field(shape, seed=h), device=dev)
    wrapper, tol = KERNEL_OF[stat]
    before = wrapper.launches
    got = tops.neighbourhood(x, h, stat)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (h > 0)
    want = (tops._xla_basic(x, h, stat) if h > 0
            else tops.neighbourhood(x.cpu(), 0, stat))
    assert wrapper.launches == before + (h > 0)
    _assert_matches(got, want, tol)


def test_kernel_rejects_what_it_cannot_take(dev):
    """A strided or f64 tensor is refused; a halfwidth past every one-block
    tile (h=300 on 600 x 700) now answers, through the wide route, within
    the kernel's bar of its plain version."""
    x = torch.zeros((64, 64), device=dev)
    big = torch.as_tensor(_field_280((600, 700), seed=30), device=dev)
    for fn, stat in ((stencil.neighbourhood_mean_cuda, 0),
                     (stencil.neighbourhood_minmax_cuda, int(gt.Max)),
                     (stencil.neighbourhood_var_cuda, int(gt.Std))):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t()[:, :32], 2, 2, stat)
        with pytest.raises(TypeError):
            fn(x.double(), 2, 2, stat)
        xb = big - 280.0 if stat == int(gt.Std) else big
        wide = fn.wide
        got = fn(xb, 300, 300, stat)
        assert fn.wide == wide + 1
        _assert_matches(got, tops._xla_basic(xb, 300, stat),
                        KERNEL_OF[stat][1])


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape,h,t", [((40, 60), 3, 11), ((17, 140), 7, 5),
                                       ((33, 33), 2, 20), ((24, 24), 0, 7),
                                       ((64, 130), 7, 11), ((2000, 2000), 7,
                                                            11)])
def test_quantile_fast_kernel_matches_plain(dev, q, shape, h, t):
    x = _field(shape, seed=h + t)
    thr = np.quantile(x[np.isfinite(x)],
                      np.linspace(0, 1, t)).astype(np.float32)
    xd, thrd = torch.as_tensor(x, device=dev), torch.as_tensor(thr,
                                                               device=dev)
    before = stencil.neighbourhood_quantile_fast_cuda.launches
    got = tops.neighbourhood_quantile_fast(xd, q, h, thrd)
    torch.cuda.synchronize()
    assert stencil.neighbourhood_quantile_fast_cuda.launches == before + 1
    want = tops._quantile_fast_xla(xd, q, h, thrd)
    _assert_matches(got, want, None)  # bit for bit, the kernel's contract


@pytest.mark.parametrize("t", [1, 4, 5, 12, 33])
@pytest.mark.parametrize("shape,h", [((256, 300), 7), ((256, 300), 8),
                                     ((180, 200), 88)])
def test_quantile_fast_kernel_packed_lanes(dev, shape, h, t):
    """K4 bit for bit on either side of the 8/16-bit lane boundary of its
    window counts (h=7: 225 cells; h=8: 289), with thresholds that fill,
    straddle and overflow its packed words (one pass or streamed groups),
    unsorted at T=12, and at h=88 (there the plain version calls K1 on the
    card, which takes h=88 by its wide route too)."""
    x = _field(shape, seed=h + t)
    thr = np.quantile(x[np.isfinite(x)], np.linspace(0, 1, t)).astype(
        np.float32)
    if t == 12:
        thr = np.random.default_rng(t).permutation(thr)
    xd, thrd = torch.as_tensor(x, device=dev), torch.as_tensor(thr,
                                                               device=dev)
    for q in (0.1, 0.5, 1.0):
        got = tops.neighbourhood_quantile_fast(xd, q, h, thrd)
        want = tops._quantile_fast_xla(xd, q, h, thrd)
        _assert_matches(got, want, None)


# statistic -> the field of the wide cases (anomaly for Std/Variance)
WIDE_SHIFT = {stat: 280.0 if stat in stencil.VAR_STATS else 0.0
              for stat in KERNEL_OF}


@pytest.mark.parametrize("stat", list(KERNEL_OF))
@pytest.mark.parametrize("shape,h", [((700, 900), 81), ((700, 900), 100),
                                     ((700, 900), 300), ((2, 400, 650), 150),
                                     ((5, 2100), 200)])
def test_wide_route_matches_plain(dev, stat, shape, h):
    """ops.neighbourhood at wide halfwidths: one call, by the route
    stencil_plan picks (the wide route), within the kernel's bar of the
    plain version on the card."""
    x = torch.as_tensor(_field_280(shape, seed=h), device=dev) \
        - WIDE_SHIFT[stat]
    wrapper, tol = KERNEL_OF[stat]
    hy, hx = min(h, shape[-2] - 1), min(h, shape[-1] - 1)
    route = stencil.stencil_plan(
        "K1" if stat in stencil.MEAN_STATS else
        "K2" if stat in stencil.MINMAX_STATS else "K3", shape, hy, hx,
        stat).route
    before, wide = wrapper.launches, wrapper.wide
    got = tops.neighbourhood(x, h, stat)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert wrapper.wide == wide + (route == "wide")
    _assert_matches(got, tops._xla_basic(x, h, stat), tol)


@pytest.mark.parametrize("stat", list(KERNEL_OF))
@pytest.mark.parametrize("shape,h", [((1, 500), 3), ((500, 1), 3),
                                     ((1, 1), 2), ((97, 301), 7),
                                     ((33, 129), 9), ((3, 130, 257), 7),
                                     ((250, 385), 5), ((16, 128), 7),
                                     ((70, 2000), 1), ((200, 130), 32),
                                     ((200, 130), 60)])
def test_strip_kernels_at_edges(dev, stat, shape, h):
    """The strip kernels K1/K2/K3 at ragged strip (X not a multiple of 128
    or 4) and row (Y not a multiple of the run or chunk) edges, 1-row and
    1-column fields, batched planes, hx above the register cap (9, 32), and
    the largest halfwidth at which K2 stays fused (60), on the 280 K field
    with 10% NaN (its anomaly for K3)."""
    x = torch.as_tensor(_field_280(shape, seed=len(shape) + h), device=dev) \
        - WIDE_SHIFT[stat]
    wrapper, tol = KERNEL_OF[stat]
    wide = wrapper.wide
    got = tops.neighbourhood(x, h, stat)
    assert wrapper.wide == wide
    _assert_matches(got, tops._xla_basic(x, h, stat), tol)


@pytest.mark.parametrize("stat", [int(gt.Mean), int(gt.Sum),
                                  int(gt.Count)])
def test_strip_counts_nan_next_to_nan_free(dev, stat):
    """A NaN-free 280 K field with NaN in a few rows and columns: chunks
    that see no NaN take the analytic count, their neighbours count, and
    both agree with the plain version."""
    rng = np.random.default_rng(17)
    x = rng.normal(280, 5, (300, 400)).astype(np.float32)
    x[40, 10] = x[41, 300] = x[170:172, 129] = np.nan
    x[299, 399] = np.inf
    xd = torch.as_tensor(x, device=dev)
    for h in (2, 7, 30):
        _assert_matches(tops.neighbourhood(xd, h, stat),
                        tops._xla_basic(xd, h, stat), TOL)


def test_count_at_the_f32_integer_edge(dev):
    """Count at h=2000 over 4001 x 4001 (wide route): the centre's window
    holds 4001^2 = 16,008,001 cells, below 2^24, exact in f32."""
    x = torch.zeros((4001, 4001), device=dev)
    x[0, 0] = torch.nan
    got = stencil.neighbourhood_mean_cuda(x, 2000, 2000, int(gt.Count))
    assert float(got[2000, 2000]) == 16008001.0 - 1
    assert float(got[4000, 4000]) == 2001.0 * 2001.0
    assert float(got[0, 0]) == 2001.0 * 2001.0 - 1


@pytest.mark.parametrize("t", [1, 5, 11, 33])
def test_quantile_fast_wide_route(dev, t):
    """K4 at h=120 (16-bit window counts), bit for bit with its plain
    version on the card, NaN positions included; and at a halfwidth
    clipped to the grid."""
    x = _field((300, 420), seed=t)
    thr = np.quantile(x[np.isfinite(x)], np.linspace(0, 1, t)).astype(
        np.float32)
    xd, thrd = torch.as_tensor(x, device=dev), torch.as_tensor(thr,
                                                               device=dev)
    for h, q in ((120, 0.1), (120, 0.5), (120, 1.0), (500, 0.5)):
        wide = stencil.neighbourhood_quantile_fast_cuda.wide
        got = tops.neighbourhood_quantile_fast(xd, q, h, thrd)
        assert stencil.neighbourhood_quantile_fast_cuda.wide == wide + 1
        _assert_matches(got, tops._quantile_fast_xla(xd, q, h, thrd), None)


@pytest.mark.parametrize("nan_frac", [0.1, 0.0])
@pytest.mark.parametrize("h", [1, 7, 8, 9, stencil.FUSED_MAX_H["K3"]])
@pytest.mark.parametrize("planes", [1, 10])
def test_var_strip_kernel_matches_plain(dev, planes, h, nan_frac):
    """K3 on the strip walk, in one launch on one plane or on EnSI's ten
    (B, Y, X) planes, up to its crossover (its one-block route), on an
    anomaly field with and without 10% NaN: within the reference's bar of
    its plain version, NaN in the same places, for Std and Variance."""
    rng = np.random.default_rng(h + planes)
    x = rng.normal(0, 5, (planes, 260, 330)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    xd = torch.as_tensor(x, device=dev)
    k3 = stencil.neighbourhood_var_cuda
    for stat in stencil.VAR_STATS:
        before, wide = k3.launches, k3.wide
        got = k3(xd, h, h, stat)
        torch.cuda.synchronize()
        assert k3.launches == before + 1 and k3.wide == wide
        _assert_matches(got, stencil.neighbourhood_var_plain(xd, h, h, stat),
                        VAR_TOL)


@pytest.mark.parametrize("t", [1, 11, 33])
@pytest.mark.parametrize("h", [8, 120, 300])
def test_quantile_fast_wide_route_cases(dev, h, t):
    """K4's wide route (running and prefix counts) at h=8, h=120 and h=300
    (361,201 cells a window, past 65,535), bit for bit
    with its plain version on the card: on a field with 10% NaN and an
    all-NaN region, and on exact cdf ties."""
    rng = np.random.default_rng(h + t)
    x = rng.normal(0, 10, (700, 900)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[100:300, 200:500] = np.nan
    thr = np.quantile(x[np.isfinite(x)], np.linspace(0, 1, t)).astype(
        np.float32)
    ties = rng.integers(0, 5, (600, 700)).astype(np.float32)
    ties[4, 7] = np.nan
    k4 = stencil.neighbourhood_quantile_fast_cuda
    for field, th, qs in ((x, thr, (0.0, 0.1, 0.5, 0.9, 1.0)),
                          (ties, np.arange(5, dtype=np.float32),
                           (float(np.float32(1.0 / 3.0)), 0.25,
                            float(np.float32(2.0 / 9.0))))):
        xd, thrd = (torch.as_tensor(field, device=dev),
                    torch.as_tensor(th, device=dev))
        for q in qs:
            wide = k4.wide
            got = tops.neighbourhood_quantile_fast(xd, q, h, thrd)
            assert k4.wide == wide + 1
            _assert_matches(got, tops._quantile_fast_xla(xd, q, h, thrd),
                            None)


def test_quantile_fast_guard_raises(dev):
    """A window of 2^31 cells or more (46341^2 here, an 8.6 GB field) raises
    the plan's ValueError before any launch: past it K4's counts would not
    fit the epilogue's int32."""
    x = torch.empty((46341, 46341), device=dev)
    thr = torch.linspace(-1, 1, 11, device=dev)
    launches = stencil.neighbourhood_quantile_fast_cuda.launches
    with pytest.raises(ValueError, match="2\\^31"):
        tops.neighbourhood_quantile_fast(x, 0.5, 23170, thr)
    assert stencil.neighbourhood_quantile_fast_cuda.launches == launches
    del x


def test_quantile_fast_past_f32_exact_counts(dev):
    """Past 2^24 cells a window (4097^2 at h=2048) K4 still answers: its
    counts stay exact integers and only their f32 conversion rounds, as
    the plain version's f32 window sums do, so the two agree within the
    reference's 1e-5 (tests/test_pallas_stencil.py:54-67), NaN in the same
    places. q lies between the cdf values, away from any bracket edge."""
    rng = np.random.default_rng(24)
    x = torch.as_tensor(rng.random((4097, 4097)).astype(np.float32),
                        device=dev)
    x[:5, :7] = torch.nan
    thr = torch.tensor([0.25, 0.5, 0.75], device=dev)
    before = stencil.neighbourhood_quantile_fast_cuda.launches
    got = tops.neighbourhood_quantile_fast(x, 0.4, 2048, thr)
    torch.cuda.synchronize()
    assert stencil.neighbourhood_quantile_fast_cuda.launches == before + 1
    _assert_matches(got, tops._quantile_fast_xla(x, 0.4, 2048, thr),
                    dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("stat", stencil.MEMBER_STATS)
@pytest.mark.parametrize("shape,h", [((320, 330, 5), 150),
                                     ((200, 257, 3), 140)])
def test_members_wide_route(dev, stat, shape, h):
    """K5 past its one-block tile (h=150, h=140 with X * E odd) through
    the wide route on the (Y, X * E) view, against its plain version and
    K1/K2 on the last member."""
    x = torch.as_tensor(_field_280(shape, seed=h), device=dev)
    tol = None if stat in stencil.MINMAX_STATS else TOL
    wide = stencil.neighbourhood_members_cuda.wide
    got = stencil.neighbourhood_members(x, h, stat)
    assert stencil.neighbourhood_members_cuda.wide == wide + 1
    hy, hx = min(h, shape[0] - 1), min(h, shape[1] - 1)
    _assert_matches(got, stencil.neighbourhood_members_plain(x, hy, hx, stat),
                    tol)
    k = shape[2] - 1
    _assert_matches(got[:, :, k],
                    tops.neighbourhood(x[:, :, k].contiguous(), h, stat), tol)


@pytest.mark.parametrize("h", [1, 7, 8])
@pytest.mark.parametrize("q", [float(np.float32(1.0 / 3.0)), 0.5, 0.25,
                               float(np.float32(2.0 / 9.0))])
def test_quantile_fast_kernel_exact_ties(dev, q, h):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 5, (30, 40)).astype(np.float32)
    x[4, 7] = np.nan
    xd = torch.as_tensor(x, device=dev)
    thr = torch.arange(5, dtype=torch.float32, device=dev)
    got = tops.neighbourhood_quantile_fast(xd, q, h, thr)
    _assert_matches(got, tops._quantile_fast_xla(xd, q, h, thr), None)


def test_quantile_fast_kernel_nan_quantile_and_region(dev):
    x = _field((40, 50), seed=3)
    x[10:20, 10:30] = np.nan
    xd = torch.as_tensor(x, device=dev)
    thr = torch.linspace(-30, 30, 9, device=dev)
    got = tops.neighbourhood_quantile_fast(xd, torch.tensor(0.5, device=dev),
                                           2, thr)
    _assert_matches(got, tops._quantile_fast_xla(xd, 0.5, 2, thr), None)
    assert torch.isnan(
        tops.neighbourhood_quantile_fast(xd, float("nan"), 2, thr)).all()
    with pytest.raises(ValueError, match="thresholds"):
        stencil.neighbourhood_quantile_fast_cuda(xd, 0.5, 2, 2, thr[:0])


@pytest.mark.parametrize("stat", stencil.MEMBER_STATS)
@pytest.mark.parametrize("shape,h", [((40, 60, 4), 3), ((17, 250, 2), 7),
                                     ((31, 31, 6), 0),
                                     ((2000, 2000, 10), 7),
                                     ((130, 257, 1), 7), ((130, 257, 3), 2),
                                     ((130, 257, 3), 7), ((130, 257, 10), 7),
                                     ((130, 257, 25), 7), ((9, 5, 64), 30)])
def test_members_kernel_matches_plain(dev, stat, shape, h):
    """K5 in one launch against its plain version and against K1/K2 on
    each member; X * E is not a multiple of 4 at X = 257 (unaligned tile
    rows)."""
    x = torch.as_tensor(_field(shape, seed=h), device=dev)
    before = stencil.neighbourhood_members_cuda.launches
    got = stencil.neighbourhood_members(x, h, stat)
    torch.cuda.synchronize()
    assert stencil.neighbourhood_members_cuda.launches == before + (h > 0)
    tol = None if stat in stencil.MINMAX_STATS else TOL
    if h > 0:
        hy, hx = min(h, shape[0] - 1), min(h, shape[1] - 1)
        want = stencil.neighbourhood_members_plain(x, hy, hx, stat)
        _assert_matches(got, want, tol)
        k = shape[2] - 1
        _assert_matches(got[:, :, k],
                        tops.neighbourhood(x[:, :, k].contiguous(), h, stat),
                        tol)
    else:
        _assert_matches(got, stencil.neighbourhood_members(x.cpu(), 0, stat),
                        None)


@pytest.mark.parametrize("stat", stencil.MEMBER_STATS)
def test_members_kernel_on_an_ensemble(dev, stat):
    """K5 on EnSI's input, a NaN-free 2000 x 2000 x 10 normal(280, 5)
    ensemble (each block takes the analytic count), against its plain
    version and K1/K2 on the first and last member."""
    x = torch.as_tensor(np.random.default_rng(5).normal(
        280, 5, (2000, 2000, 10)).astype(np.float32), device=dev)
    tol = None if stat in stencil.MINMAX_STATS else TOL
    got = stencil.neighbourhood_members(x, 7, stat)
    _assert_matches(got, stencil.neighbourhood_members_plain(x, 7, 7, stat),
                    tol)
    for k in (0, 9):
        _assert_matches(got[:, :, k],
                        tops.neighbourhood(x[:, :, k].contiguous(), 7, stat),
                        tol)


def _problem(seed=7, n=80, n_obs=120):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n), np.linspace(5, 8, n),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 58, n_obs), rng.uniform(5, 8, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    bg = rng.normal(280, 5, (n, n)).astype(np.float32)
    pobs = (bg.reshape(-1)[grid.nearest_map(pts.lats, pts.lons)]
            + rng.normal(0, 2, n_obs)).astype(np.float32)
    return grid, pts, bg, pobs, np.full(n_obs, 0.2, np.float32)


@pytest.mark.parametrize("stat,halfwidth", [("Mean", 3), ("Max", 3),
                                            ("Std", 3), ("Mean", 100)])
def test_pipeline_on_card(dev, stat, halfwidth):
    """Pipeline on the card: general == resolve bit for bit, within 1e-3
    of the CPU's plain versions; at halfwidth 100, on a 200 x 200 grid,
    the smoothing takes K1's wide route."""
    grid, pts, bg, pobs, ratios = _problem(n=200 if halfwidth == 100
                                           else 80)
    if stat == "Std":
        # E[x^2] - E[x]^2 of the 280 K field cancels most of f32's digits
        # (tests/test_torch_pipeline.py); smooth its anomaly instead
        bg, pobs = bg - np.float32(280.0), pobs - np.float32(280.0)
    kw = dict(halfwidth=halfwidth, statistic=getattr(gt.Statistic, stat),
              max_points=8, tiled=True, tile_shape=(16, 32), ratios=ratios)
    card = gt.Pipeline(grid, pts, gt.BarnesStructure(30000.0), device=dev,
                       **kw)
    cpu = gt.Pipeline(grid, pts, gt.BarnesStructure(30000.0), device="cpu",
                      **kw)
    gap = pobs.copy()
    gap[::3] = np.nan
    k1 = stencil.neighbourhood_mean_cuda
    wide, calls = k1.wide, k1.launches
    for po in (pobs, pobs + 1.0, gap):
        bgd, pod = torch.as_tensor(bg, device=dev), torch.as_tensor(
            po, device=dev)
        general = card.run_device(bgd, pod, ratios, path="general")
        resolve = card.run_device(bgd, pod, ratios, path="resolve")
        assert torch.equal(general, resolve)
        want = cpu.run_device(torch.as_tensor(bg), torch.as_tensor(po),
                              ratios, path="general")
        np.testing.assert_allclose(general.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=1e-3)
    if stat == "Mean":
        assert k1.launches > calls
        assert k1.wide - wide == (k1.launches - calls
                                  if halfwidth == 100 else 0)
    with pytest.raises(ValueError, match="runs on cuda"):
        card.run_device(torch.as_tensor(bg), torch.as_tensor(pobs))


def _ens_problem(seed=9, n=64, n_obs=100, e=5):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 57, n), np.linspace(5, 7, n),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 57, n_obs), rng.uniform(5, 7, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    bg = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    bgc = (bg + rng.normal(0, 1, bg.shape)).astype(np.float32)
    pback = bg.reshape(-1, e)[grid.nearest_map(pts.lats, pts.lons)]
    pobs = (pback.mean(axis=1) + rng.normal(0, 2, n_obs)).astype(np.float32)
    pobs_e = (pback + rng.normal(0, 1, (n_obs, e))).astype(np.float32)
    return grid, pts, bg, bgc, pobs, pobs_e


@pytest.mark.parametrize("halfwidth", [0, 7])
def test_ensi_pipeline_on_card(dev, halfwidth):
    """EnSI on the card: one K5 launch per smoothed cycle and one EnSI
    kernel launch per block, the all-valid fast path equal to the general
    path bit for bit, no condition failures, and the card within 2e-3 of
    the CPU's plain versions."""
    grid, pts, bg, _, pobs, _ = _ens_problem()
    kw = dict(halfwidth=halfwidth, statistic=gt.Mean, max_points=10)
    card = gt.EnsiPipeline(grid, pts, gt.BarnesStructure(30000.0),
                           device=dev, **kw)
    cpu = gt.EnsiPipeline(grid, pts, gt.BarnesStructure(30000.0),
                          device="cpu", **kw)
    psig = np.full(pobs.size, 1.5, np.float32)
    gap = pobs.copy()
    gap[::3] = np.nan
    for po, fast in ((pobs, True), (gap, False)):
        args = [torch.as_tensor(a, device=dev) for a in (bg, po, psig)]
        before = stencil.neighbourhood_members_cuda.launches
        ensi = oi_ensi.ensi_update_cuda.launches
        out, n_cond = card.run_device(*args, assume_valid=fast)
        torch.cuda.synchronize()
        assert stencil.neighbourhood_members_cuda.launches \
            == before + (halfwidth > 0)
        assert oi_ensi.ensi_update_cuda.launches == ensi + 1
        assert n_cond.device == dev and int(n_cond) == 0
        assert bool(torch.isfinite(out).all())
        if fast:
            assert torch.equal(out, card.run_device(*args)[0])
        want, _ = cpu.run_device(*(torch.as_tensor(a) for a in (bg, po,
                                                                psig)))
        np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=2e-3)
    with pytest.raises(ValueError, match="runs on cuda"):
        card.run_device(torch.as_tensor(bg), torch.as_tensor(pobs),
                        torch.as_tensor(psig))


# -- the EnSI transform's kernel (csrc/ensi_transform.cu) ---------------------
OP_ATOL = 2e-3  # the EnSI update's bar, tests/test_torch_ensi.py


def _ensi_block(seed, b, s, e, p=40):
    """The kernel's inputs (g, rho, valid, tab, background) for b rows of
    s slots and e members over a table of p obs, with what the guards
    meet: about 30% of slots invalid, every 7th row without a valid obs,
    NaN rho on invalid slots (read on valid slots alone), row 3's invalid
    first slot on an obs whose anomalies are NaN (a non-finite Pinv: cond_
    bad where the row has a valid slot), row 5's valid first slot on an
    obs that is NaN (a non-finite analysis) and a NaN member in row 9."""
    rng = np.random.default_rng(seed)
    tab = np.empty((p, 3 + e), np.float32)
    tab[:, 0] = rng.normal(281, 2, p)
    tab[:, 1] = rng.uniform(0.5, 2, p)
    tab[:, 2] = rng.normal(280, 1, p)
    tab[:, 3:] = rng.normal(0, 2, (p, e))
    tab[p - 1, 3:] = np.nan
    tab[p - 2, 0] = np.nan
    g = rng.integers(0, p - 2, (b, s))
    valid = rng.random((b, s)) < 0.7
    valid[::7] = False
    g[3, 0], valid[3, 0], valid[3, 1:] = p - 1, False, True
    g[5, 0], valid[5, 0] = p - 2, True
    rho = rng.uniform(0.05, 1, (b, s)).astype(np.float32)
    rho[~valid] = np.nan
    bg = rng.normal(280, 5, (b, e)).astype(np.float32)
    bg[9, 0] = np.nan
    return [torch.as_tensor(a) for a in (g, rho, valid, tab, bg)]


@pytest.mark.parametrize("allow", [True, False])
@pytest.mark.parametrize("s", [1, 5, 10, 20])
@pytest.mark.parametrize("e", [3, 5, 10, 16, 17, 32])
def test_ensi_kernel_matches_plain_chain(dev, e, s, allow):
    """The kernel on the card against the plain chain on the CPU: within
    OP_ATOL, NaN in the same places, cond_bad equal; rows without a valid
    obs, with a non-finite transform or analysis keep their background;
    without extrapolation the clamp's count-stride quirk is the chain's."""
    args = _ensi_block(100 * e + s, 300, s, e)
    before = oi_ensi.ensi_update_cuda.launches
    out, bad = oi_ensi.ensi_update_cuda(*(a.to(dev) for a in args), allow)
    torch.cuda.synchronize()
    assert oi_ensi.ensi_update_cuda.launches == before + 1
    want, want_bad = oi_ensi.ensi_update_plain(*args, allow)
    got, bad = out.cpu(), bad.cpu()
    assert torch.equal(bad, want_bad)
    assert bool(bad[3]) == (s > 1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=OP_ATOL)
    bg, valid = args[4], args[2]
    kept = ~valid.any(dim=1) | bad
    kept[5] = True
    assert torch.equal(got[kept].nan_to_num(), bg[kept].nan_to_num())
    assert torch.equal(got[9].nan_to_num(), bg[9].nan_to_num())


def _ensi_float64(valid, rho, obs, sig, y, yhat, background):
    """EnSI as oi_ensi.cpp:296-444 computes it, in float64 with eigh (as
    tests/test_torch_ensi.py::_ensi_float64)."""
    e = background.shape[1]
    rinv = np.where(valid, rho / sig.astype(np.float64) ** 2, 0.0)
    innov = np.where(valid, obs.astype(np.float64) - yhat, 0.0)
    y = y.astype(np.float64)
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
def test_ensi_kernel_matches_float64_eigh(dev, seed):
    """ROADMAP F6 on the card: test_ensi_update_matches_float64_eigh's
    inputs (innovations ~10 K against the weights), each row's slots its
    own rows of the table; the kernel within 1e-3 K of float64 eigh."""
    rng = np.random.default_rng(seed)
    b, s, e = 4000, 10, 10
    valid = np.ones((b, s), bool)
    rho = rng.uniform(0.3, 1, (b, s)).astype(np.float32)
    obs = rng.normal(290, 5, (b, s)).astype(np.float32)
    sig = np.full((b, s), 1.5, np.float32)
    y = rng.normal(0, 5, (b, s, e)).astype(np.float32)
    yhat = rng.normal(280, 1, (b, s)).astype(np.float32)
    bg = rng.normal(280, 5, (b, e)).astype(np.float32)
    exact = _ensi_float64(valid, rho, obs, sig, y, yhat, bg)
    tab = np.concatenate([obs.reshape(-1, 1), sig.reshape(-1, 1),
                          yhat.reshape(-1, 1), y.reshape(-1, e)], axis=1)
    g = np.arange(b * s).reshape(b, s)
    out, bad = oi_ensi.ensi_update_cuda(
        *(torch.as_tensor(a, device=dev) for a in (g, rho, valid, tab, bg)),
        True)
    assert not bool(bad.any())
    assert np.abs(out.cpu().numpy() - exact).max() < 1e-3


@pytest.mark.parametrize("assume_valid", [True, False])
def test_ensi_kernel_block_size_independent(dev, assume_valid):
    """EnsiPipeline on the card gives the same bits whatever its block:
    one kernel launch a block (1 at the default, 111 at 37 rows)."""
    grid, pts, bg, _, pobs, _ = _ens_problem()
    po = pobs.copy()
    if not assume_valid:
        po[::4] = np.nan
    args = [torch.as_tensor(a, device=dev)
            for a in (bg, po, np.full(pobs.size, 1.5, np.float32))]
    outs = []
    for block, launches in ((1 << 20, 1), (37, -(-bg.shape[0] ** 2 // 37))):
        pipe = gt.EnsiPipeline(grid, pts, gt.BarnesStructure(30000.0),
                               block=block, device=dev)
        before = oi_ensi.ensi_update_cuda.launches
        outs.append(pipe.run_device(*args, assume_valid=assume_valid))
        assert oi_ensi.ensi_update_cuda.launches - before == launches
    assert torch.equal(outs[0][0], outs[1][0])
    assert int(outs[0][1]) == int(outs[1][1]) == 0


def test_ensi_kernel_rejects_what_it_cannot_take(dev):
    """The wrapper raises on a CPU tensor among CUDA ones and past 32
    members; the sweep sends E = 33 to the chain by its shape."""
    args = [a.to(dev) for a in _ensi_block(0, 20, 4, 6)]
    with pytest.raises(ValueError, match="CUDA"):
        oi_ensi.ensi_update_cuda(args[0], args[1], args[2], args[3].cpu(),
                                 args[4], True)
    wide = [a.to(dev) for a in _ensi_block(1, 20, 4, 33)]
    with pytest.raises(ValueError, match="members"):
        oi_ensi.ensi_update_cuda(*wide, True)
    assert not oi_ensi.kernel_takes(dev, torch.float32, 33, 4)
    assert oi_ensi.kernel_takes(dev, torch.float32, 32, 32)


@pytest.mark.parametrize("variant,tol", [("ebe", 1e-3), ("ebesc", 1e-3),
                                         ("utem", 2e-3)])
def test_multi_pipeline_on_card(dev, variant, tol):
    grid, pts, bg, bgc, pobs, pobs_e = _ens_problem(seed=10)
    po = pobs if variant == "utem" else pobs_e
    ratios = np.full(pobs.size, 0.1, np.float32)
    kw = dict(variant=variant, max_points=10)
    outs = {}
    for d in (dev, torch.device("cpu")):
        pipe = gt.MultiEnsiPipeline(grid, pts, gt.BarnesStructure(30000.0),
                                    device=d, **kw)
        out, n_cond = pipe.run_device(
            *(torch.as_tensor(a, device=d) for a in (bg, po, ratios, bgc)))
        assert int(n_cond) == 0
        outs[d.type] = out.cpu().numpy()
    assert np.isfinite(outs["cuda"]).all()
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=0, atol=tol)


def _bench_cut(m=256, e=10):
    """A 256 x 256 cut of bench.py's problem (seed 0, its draws as
    gridpp_tpu_torch.tools.bench.field_draws makes them): the corner of the
    2000 x 2000 grid, the stations inside it, their obs, and e members of
    normal(280, 5) with perturbed obs."""
    from gridpp_tpu_torch.tools import bench
    rng = np.random.default_rng(0)
    lats, lons, plats, plons, background, noise = bench.field_draws(
        rng, 2000, 10000)
    inside = ((plats >= lats[0, 0]) & (plats <= lats[m - 1, 0])
              & (plons >= lons[0, 0]) & (plons <= lons[0, m - 1]))
    k = int(inside.sum())
    grid = gt.Grid(lats[:m, :m], lons[:m, :m])
    pts = gt.Points(plats[inside], plons[inside], np.zeros(k), np.zeros(k))
    bg = np.ascontiguousarray(background[:m, :m])
    idx = grid.nearest_map(pts.lats, pts.lons)
    pobs = bg.reshape(-1)[idx] + noise[inside]
    ens = rng.normal(280, 5, (m, m, e)).astype(np.float32)
    pobs_e = (ens.reshape(-1, e)[idx]
              + rng.normal(0, 1, (k, e))).astype(np.float32)
    return grid, pts, bg, pobs, ens, pobs_e


def _streamed_pipe(kind, dev, cut):
    """(pipeline on dev, 4 host cycles) of kind at bench.py's settings:
    Pipeline Mean h=7 (all-valid cycles take the fast path; "general":
    each cycle's ratios unlike the static ones), EnsiPipeline, or
    MultiEnsiPipeline ebesc, ebe, utem."""
    grid, pts, bg, pobs, ens, pobs_e = cut
    st = gt.BarnesStructure(10000.0)
    k = pobs.size
    ratios = np.full(k, 0.1, np.float32)
    if kind in ("pipeline", "general"):
        pipe = gt.Pipeline(grid, pts, st, halfwidth=7, statistic=gt.Mean,
                           max_points=10, ratios=ratios, device=dev)
        return pipe, [(bg + np.float32(i), pobs + np.float32(i))
                      + ((ratios * np.float32(1 + i),) if kind == "general"
                         else ()) for i in range(4)]
    if kind == "ensi":
        pipe = gt.EnsiPipeline(grid, pts, st, max_points=10, device=dev)
        return pipe, [(ens + np.float32(i), pobs,
                       np.full(k, 1.5, np.float32)) for i in range(4)]
    pipe = gt.MultiEnsiPipeline(grid, pts, st, variant=kind, max_points=10,
                                device=dev)
    po = pobs if kind == "utem" else pobs_e
    return pipe, [(ens + np.float32(i), po, ratios)
                  + (() if kind == "ebesc" else (ens - np.float32(i),))
                  for i in range(4)]


@pytest.mark.parametrize("kind", ["pipeline", "general", "ensi", "ebesc",
                                  "ebe", "utem"])
def test_serve_stream_on_card_matches_call_loop(dev, kind):
    """serve_stream on the card (pinned staging, copy streams) yields, in
    order and bit for bit, what a loop of __call__ gives; the Pipeline
    launches K1 once a cycle."""
    pipe, cycles = _streamed_pipe(kind, dev, _bench_cut())
    k1 = stencil.neighbourhood_mean_cuda
    before = k1.launches
    streamed = list(pipe.serve_stream(cycles))
    if kind in ("pipeline", "general"):
        assert k1.launches - before == len(cycles)
    looped = [pipe(*c) for c in cycles]
    assert len(streamed) == len(cycles)
    for got, want in zip(streamed, looped):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(streamed[-1]).all()
    assert not np.array_equal(streamed[0], streamed[1])


@pytest.mark.parametrize("kind", ["pipeline", "ensi"])
def test_serve_stream_yield_outlives_later_cycles(dev, kind):
    """A yielded analysis is the caller's: two further cycles through the
    stream's pinned buffers leave it as it was."""
    pipe, cycles = _streamed_pipe(kind, dev, _bench_cut())
    stream = pipe.serve_stream(cycles)
    first = next(stream)
    kept = first.copy()
    second, third = next(stream), next(stream)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(first, pipe(*cycles[0]))
    assert not np.shares_memory(first, second)
    assert not np.shares_memory(second, third)
    assert len(list(stream)) == 1


@pytest.mark.parametrize("kind", ["pipeline", "ensi"])
def test_serve_stream_recycles_released_yields(dev, kind):
    """A caller that drops each analysis once it has read it: over six
    cycles every analysis still equals the call loop's bit for bit, and
    the later ones are copied out into the arrays dropped before them
    (`serve.fetch.recycled`)."""
    pipe, cycles = _streamed_pipe(kind, dev, _bench_cut())
    cycles += [(c[0] + np.float32(0.5),) + c[1:] for c in cycles[:2]]
    looped = [pipe(*c) for c in cycles]
    seen = []

    def serve():
        for got in pipe.serve_stream(cycles):
            np.testing.assert_array_equal(got, looped[len(seen)])
            seen.append(got.__array_interface__["data"][0])
            del got

    _, s = _traced(serve)
    assert len(seen) == 6
    assert s.counts["serve.cycles"] == 6
    assert s.counts["serve.fetch.recycled"] >= 3
    assert (s.counts["serve.fetch.recycled"]
            + s.counts.get("serve.fetch.fresh", 0)) == 6
    assert len(set(seen)) < len(seen)


def _traced(fn, cuda=False):
    """fn() under a profiler session (host records, and the card's with
    cuda), after a record made with the profiler off so that the tracing
    session is a new one; returns (profiler, session)."""
    from torch.profiler import ProfilerActivity, profile
    from gridpp_tpu_torch import tracing
    tracing.count("serve.cycles")   # off: records nothing
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof, tracing.session()


def test_serve_stream_spans_on_card(dev):
    """gridpp_tpu_torch.tracing on the card. A fresh Pipeline's 4 all-valid
    cycles: the first captures the fast graph (gridpp.cycle.capture under
    its gridpp.cycle), the others replay it; cycles 2 and 3 wait for the
    upload from their staging set's last use, every fetch for its
    download. Under a card trace the spans' device-timeline copies are
    user annotations, not device work. Cycles with a third of the obs
    missing take the general path after one host sync each. Each cycle's
    two arrays are staged by the one host pass that copies and checks
    (`serve.stage.fused`), none converted. The fresh pipeline's four
    analyses are copied out into new arrays (`serve.fetch.fresh`); each
    later call, whose list of analyses is held whole, finds two of them
    released (`serve.fetch.recycled`, the pool's cap)."""
    pipe, cycles = _streamed_pipe("pipeline", dev, _bench_cut())
    _, s = _traced(lambda: list(pipe.serve_stream(cycles)))
    assert s.counts == {"serve.cycles": 4, "cycle.fast": 4,
                        "graph.capture": 1, "graph.replay": 3,
                        "serve.stage.fused": 8, "serve.fetch.fresh": 4}
    got = sorted((n, p, c) for n, p, c, _, _ in s.spans)
    want = sorted(
        [(n, None, c) for c in range(4) for n in (
            "gridpp.serve.check", "gridpp.serve.stage", "gridpp.cycle",
            "gridpp.serve.fetch")]
        + [("gridpp.serve.fetch.wait", "gridpp.serve.fetch", c)
           for c in range(4)]
        + [("gridpp.serve.stage.wait", "gridpp.serve.stage", c)
           for c in (2, 3)]
        + [("gridpp.cycle.capture", "gridpp.cycle", 0)])
    assert got == want

    prof, s = _traced(lambda: list(pipe.serve_stream(cycles)), cuda=True)
    assert s.counts == {"serve.cycles": 4, "cycle.fast": 4,
                        "graph.replay": 4, "serve.stage.fused": 8,
                        "serve.fetch.recycled": 2, "serve.fetch.fresh": 2}
    ours = [e for e in prof.events() if e.name.startswith("gridpp.")]
    assert {e.name for e in ours} >= {n for n, *_ in s.spans}
    assert any(e.device_type == torch.autograd.DeviceType.CUDA
               for e in ours)
    assert all(e.is_user_annotation for e in ours)

    gaps = [(bg, po.copy()) for bg, po in cycles]
    for _, po in gaps:
        po[::3] = np.nan
    _, s = _traced(lambda: list(pipe.serve_stream(gaps)))
    assert s.counts == {"serve.cycles": 4, "cycle.general": 4,
                        "host.sync": 4, "graph.capture": 1,
                        "graph.replay": 3, "serve.stage.fused": 8,
                        "serve.fetch.recycled": 2, "serve.fetch.fresh": 2}
    assert sorted((p, c) for n, p, c, _, _ in s.spans
                  if n == "gridpp.cycle.sync") == [
        ("gridpp.cycle", c) for c in range(4)]


def test_ensi_serve_stream_nan_member_takes_general_path(dev):
    """A NaN in one member value (not in pobs) of one served cycle: the
    host pass's answer sends that cycle, and only it, down EnSI's
    re-selecting path (cycle.ensi), and every cycle still equals the call
    loop bit for bit."""
    pipe, cycles = _streamed_pipe("ensi", dev, _bench_cut())
    ens = cycles[2][0].copy()
    ens[100, 37, 4] = np.nan
    cycles[2] = (ens,) + cycles[2][1:]
    streamed = []
    _, s = _traced(lambda: streamed.extend(pipe.serve_stream(cycles)))
    assert s.counts["serve.cycles"] == 4
    assert s.counts["cycle.ensi_prefix"] == 3 and s.counts["cycle.ensi"] == 1
    assert s.counts["serve.stage.fused"] == 12
    assert "serve.stage.converted" not in s.counts
    looped = [pipe(*c) for c in cycles]
    assert len(streamed) == len(looped)
    for got, want in zip(streamed, looped):
        np.testing.assert_array_equal(got, want)


def test_ensi_serve_stream_counts_kernel_launches(dev):
    """EnsiPipeline's serving stream on the card under a profiler session:
    `kernel.ensi_update` counts one launch a block of each served cycle,
    and the session's device records hold the EnSI kernel and no cuBLAS
    product."""
    grid, pts, _, pobs, ens, _ = _bench_cut()
    k = pobs.size
    pipe = gt.EnsiPipeline(grid, pts, gt.BarnesStructure(10000.0),
                           max_points=10, block=1 << 14, device=dev)
    cycles = [(ens + np.float32(i), pobs, np.full(k, 1.5, np.float32))
              for i in range(3)]
    list(pipe.serve_stream(cycles[:1]))
    prof, s = _traced(lambda: list(pipe.serve_stream(cycles)), cuda=True)
    blocks = -(-ens.shape[0] * ens.shape[1] // pipe.block)
    assert s.counts["serve.cycles"] == 3
    assert s.counts["kernel.ensi_update"] == 3 * blocks == 12
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("ensi_transform_kernel" in n for n in names)
    assert not any("gemm" in n or "gemv" in n for n in names)


def _graph_cycles(bg, pobs, ratios, dev):
    """The 8-cycle validity/ratios sequence of
    tests/test_torch_pipeline_graph.py on the card: cold; hit; hit; a
    third of the obs missing (rebuild); hit; all valid again (rebuild);
    hit; ratios 0.05 (rebuild). (background, pobs, ratios) tensors."""
    gap = pobs.copy()
    gap[::3] = np.nan
    other = np.full_like(ratios, 0.05)
    return [(torch.as_tensor(bg + np.float32(0.5 * i), device=dev),
             torch.as_tensor((gap if i in (3, 4) else pobs) + np.float32(i),
                             device=dev),
             torch.as_tensor(other if i == 7 else ratios, device=dev))
            for i in range(8)]


GRAPH_REBUILT = {0, 3, 5, 7}


def test_graphed_cycles_wait_on_nothing_on_the_host(dev):
    """After a path's first call, replays of the general and fast graphs
    under torch.cuda.set_sync_debug_mode("error"), with assume_valid=True
    and pratios None, numpy unlike the static ratios and a tensor: no
    synchronisation; the answers equal the resolve path's."""
    grid, pts, bg, pobs, _, _ = _bench_cut()
    k = pobs.size
    ratios = np.full(k, 0.1, np.float32)
    pipe = gt.Pipeline(grid, pts, gt.BarnesStructure(10000.0), halfwidth=7,
                       statistic=gt.Mean, max_points=10, ratios=ratios,
                       device=dev)
    bgs = [torch.as_tensor(bg + np.float32(i), device=dev) for i in range(3)]
    po = torch.as_tensor(pobs, device=dev)
    other = np.full(k, 0.2, np.float32)
    other_t = torch.as_tensor(other, device=dev)
    forms = [dict(path="general"), dict(path="general", pratios=other),
             dict(path="general", pratios=other_t),
             dict(path="fast", assume_valid=True), dict(assume_valid=True)]
    for kw in forms:  # first calls: capture, pinned buffers
        pipe.run_device(bgs[0], po, **kw)
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in bgs[1:]:
            for kw in forms:
                outs.append(pipe.run_device(b, po, **kw))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i, b in enumerate(bgs[1:]):
        for j, kw in enumerate(forms):
            got = outs[i * len(forms) + j]
            pr = kw.get("pratios")
            want = pipe.run_device(b, po, ratios if pr is None else pr,
                                   path="resolve")
            if kw.get("path") == "general":
                assert torch.equal(got, want), kw
            else:
                assert float((got - want).abs().max()) <= 1e-3, kw


def test_graphed_general_sequence_at_full_size(dev):
    """bench.py's Pipeline (2000 x 2000, 10,000 obs, Mean h=7,
    max_points 10): the 8-cycle sequence through the general graph equals
    the eager re-solve bit for bit on every cycle, rebuilds exactly on the
    cycles whose validity or ratios changed (the `rebuilds` counter), keeps
    each returned analysis as it was after the next cycle, and launches K1
    once a cycle (the first eager, then one a replay); fast stays within
    1e-3 of general on the all-valid cycles."""
    from gridpp_tpu_torch.ops import graph
    from gridpp_tpu_torch.tools import bench
    lats, lons, plats, plons, background, noise = bench.field_draws(
        np.random.default_rng(0), 2000, 10000)
    grid = gt.Grid(lats, lons)
    p = plats.size
    pts = gt.Points(plats, plons, np.zeros(p), np.zeros(p))
    pobs = (background.reshape(-1)[grid.nearest_map(plats, plons)]
            + noise).astype(np.float32)
    ratios = np.full(p, 0.1, np.float32)
    pipe = gt.Pipeline(grid, pts, gt.BarnesStructure(10000.0), halfwidth=7,
                       statistic=gt.Mean, max_points=10, ratios=ratios,
                       device=dev)
    cycles = _graph_cycles(background, pobs, ratios, dev)
    k1 = stencil.neighbourhood_mean_cuda
    k1.launches = graph.begin_if.launches = 0
    general, kept, counts = [], [], []
    for b, po, ra in cycles:
        general.append(pipe.run_device(b, po, ra, path="general"))
        kept.append(general[-1].clone())
        counts.append(int(pipe.rebuilds))
    assert k1.launches == len(cycles)
    assert graph.begin_if.launches == len(cycles) - 1
    rebuilt = {i for i, n in enumerate(counts)
               if n != (counts[i - 1] if i else 0)}
    assert rebuilt == GRAPH_REBUILT
    for i, (b, po, ra) in enumerate(cycles):
        assert torch.equal(general[i], kept[i])
        assert torch.isfinite(general[i]).all()
        assert torch.equal(general[i], pipe.run_device(b, po, ra,
                                                       path="resolve"))
        if i not in (3, 4, 7):
            fast = pipe.run_device(b, po, path="fast", assume_valid=True)
            assert float((fast - general[i]).abs().max()) <= 1e-3


def test_ensemble_transform_refuses_tf32(dev):
    """EnsiPipeline's transform is the EnSI kernel, which never reaches
    cuBLAS: its result is the same with TF32 on and off. The chain that
    keeps the batched products (ops.oi_ensi._mm) still refuses TF32:
    utem's MultiEnsiPipeline, and EnSI past the kernel's 32 members."""
    st = gt.BarnesStructure(30000.0)
    grid, pts, bg, bgc, pobs, _ = _ens_problem(n=16, n_obs=20)
    psig = np.full(pobs.size, 1.5, np.float32)
    ratios = np.full(pobs.size, 0.1, np.float32)
    pipe = gt.EnsiPipeline(grid, pts, st, device=dev)
    utem = gt.MultiEnsiPipeline(grid, pts, st, variant="utem", device=dev)
    _, _, bg33, _, pobs33, _ = _ens_problem(n=16, n_obs=20, e=33)
    wide = gt.EnsiPipeline(grid, pts, st, device=dev)
    args = [torch.as_tensor(a, device=dev) for a in (bg, pobs, psig)]
    args_utem = [torch.as_tensor(a, device=dev)
                 for a in (bg, pobs, ratios, bgc)]
    args33 = [torch.as_tensor(a, device=dev) for a in (bg33, pobs33, psig)]
    off = pipe.run_device(*args)[0]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(pipe.run_device(*args)[0], off)
        with pytest.raises(RuntimeError, match="TF32"):
            utem.run_device(*args_utem)
        with pytest.raises(RuntimeError, match="TF32"):
            wide.run_device(*args33)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    utem.run_device(*args_utem)
    wide.run_device(*args33)


def _api_problem(seed=13, n=40, n_obs=60, e=5, starved=False):
    """A 40 x 40 network with an ensemble for the OI API. starved drops
    two thirds of the obs: truncated shortlist rows then keep fewer than
    max_points valid candidates, and the device route falls back to the
    host-candidate kernels on the card."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n), np.linspace(5, 8, n),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 58, n_obs), rng.uniform(5, 8, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    nn = grid.nearest_map(pts.lats, pts.lons)
    bg = rng.normal(280, 5, (n, n)).astype(np.float32)
    ens = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    ensc = (ens + rng.normal(0, 1, ens.shape)).astype(np.float32)
    pback_e = ens.reshape(-1, e)[nn]
    d = dict(grid=grid, pts=pts, bg=bg, ens=ens, ensc=ensc,
             pback=bg.reshape(-1)[nn], pback_e=pback_e,
             pbackc=ensc.reshape(-1, e)[nn],
             pobs=(bg.reshape(-1)[nn] + rng.normal(0, 1, n_obs)).astype(
                 np.float32),
             pobs_m=(pback_e.mean(axis=1) + rng.normal(0, 1, n_obs)).astype(
                 np.float32),
             pobs_e=(pback_e + rng.normal(0, 1, (n_obs, e))).astype(
                 np.float32),
             ratios=np.full(n_obs, 0.1, np.float32),
             bvar=rng.uniform(0.5, 2, (n, n)).astype(np.float32),
             pbvar=rng.uniform(0.5, 2, n_obs).astype(np.float32),
             bratios=np.ones((n, n), np.float32))
    drop = (np.arange(n_obs) % 3 != 0) if starved else np.zeros(n_obs, bool)
    for key in ("pobs", "pobs_m", "pobs_e"):
        d[key][drop] = np.nan
    return d


def _api_call(fn, d, owner):
    """Call API function fn (oi, full, ensi, ebe, ebesc, utem) of owner, a
    namespace: the port's top level or one of its api modules."""
    s = gt.BarnesStructure(30000.0)
    g, p = d["grid"], d["pts"]
    if fn == "oi":
        return owner.optimal_interpolation(g, d["bg"], p, d["pobs"],
                                           d["ratios"], d["pback"], s, 8)
    if fn == "full":
        return owner.optimal_interpolation_full(
            g, d["bg"], d["bvar"], p, d["pobs"], d["ratios"], d["pback"],
            d["pbvar"], s, 8)
    if fn == "ensi":
        return owner.optimal_interpolation_ensi(
            g, d["ens"], p, d["pobs_m"], np.full(p.size(), 1.5, np.float32),
            d["pback_e"], s, 8)
    multi = getattr(owner, f"optimal_interpolation_ensi_multi_{fn}")
    if fn == "ebesc":
        return multi(g, d["bratios"], d["ens"], p, d["pobs_e"], d["ratios"],
                     d["pback_e"], s, 8)
    return multi(g, d["bratios"], d["ens"], d["ensc"], p,
                 d["pobs_m"] if fn == "utem" else d["pobs_e"], d["ratios"],
                 d["pback_e"], d["pbackc"], s, 8)


@pytest.mark.parametrize("starved", [False, True],
                         ids=["shortlist", "starved"])
@pytest.mark.parametrize("fn", ["oi", "full", "ensi", "ebe", "ebesc",
                                "utem"])
def test_api_device_route_on_card(dev, fn, starved, monkeypatch):
    """Each OI API function's device route on the card (its module
    function called under the card as torch's default device) against
    the same call on the host route (the top-level function, pinned to
    the CPU: the native solvers): max|d| < 1e-2, the API's contract
    (tests/test_parity_dense.py:10). The starved case runs the
    host-candidate kernels on the card."""
    from gridpp_tpu_torch.api import oi as tapi
    from gridpp_tpu_torch.api import oi_ensi as tensi
    from gridpp_tpu_torch.api import oi_ensi_multi as tmulti
    kernels = {"oi": (tapi, "oi_gather_block"),
               "full": (tapi, "oi_gather_block"),
               "ensi": (tensi, "ensi_kernel")}
    mod, name = kernels.get(fn, (tmulti, f"{fn}_kernel"))
    calls = []
    real = getattr(mod, name)

    def record(*a, **k):
        calls.append(a[1][next(iter(a[1]))].device)
        return real(*a, **k)

    monkeypatch.setattr(mod, name, record)
    d = _api_problem(starved=starved)
    owner = {"oi": tapi, "full": tapi, "ensi": tensi}.get(fn, tmulti)
    with torch.device(dev):
        got = _api_call(fn, d, owner)
    want = _api_call(fn, d, gt)
    assert all(c == dev for c in calls) and bool(calls) == starved
    for a, b in zip(got if fn == "full" else (got,),
                    want if fn == "full" else (want,)):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() < 1e-2, np.abs(a - b).max()


def _downscale_problem(seed=14, n_src=(300, 240), n_tgt=2000):
    """A 300 x 240 source with elevations and lafs over 55-62N 5-12E, the
    benchmark's 2000 x 2000 target with its own, 500 stations, and (T, Y,
    X) temperatures with a share missing."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 62, n_src[0]),
                             np.linspace(5, 12, n_src[1]), indexing="ij")
    olats, olons = np.meshgrid(np.linspace(55, 62, n_tgt),
                               np.linspace(5, 12, n_tgt), indexing="ij")
    src = gt.Grid(lats, lons,
                  rng.uniform(0, 2000, lats.shape).astype(np.float32),
                  rng.uniform(0, 1, lats.shape).astype(np.float32))
    tgt = gt.Grid(olats, olons,
                  rng.uniform(0, 2000, olats.shape).astype(np.float32),
                  rng.uniform(0, 1, olats.shape).astype(np.float32))
    pts = gt.Points(rng.uniform(54.9, 62.1, 500), rng.uniform(4.9, 12.1, 500),
                    rng.uniform(0, 2000, 500), rng.uniform(0, 1, 500))
    vals = rng.normal(280, 5, (3,) + lats.shape).astype(np.float32)
    vals[rng.random(vals.shape) < 0.02] = np.nan
    return src, tgt, pts, vals


def test_downscalers_on_card(dev):
    """nearest (equal) and bilinear (rtol 1e-6, atol 1e-4) to the 2000 x
    2000 grid and to points, through the module functions on the card,
    against the host route; the second call reuses the map's tensors."""
    from gridpp_tpu_torch.api import downscaling as tdown
    src, tgt, pts, vals = _downscale_problem()
    for target in (tgt, pts):
        with torch.device(dev):
            near = tdown.nearest(src, target, vals)
            bil = tdown.bilinear(src, target, vals)
        assert np.array_equal(near, gt.nearest(src, target, vals),
                              equal_nan=True)
        np.testing.assert_allclose(bil, gt.bilinear(src, target, vals),
                                   rtol=1e-6, atol=1e-4)
    cache = src.__dict__["_downscale_maps"][tgt]
    maps = cache[("bilinear", dev)]
    assert all(t.device == dev for t in maps)
    with torch.device(dev):
        tdown.bilinear(src, tgt, vals[:1])
    assert cache[("bilinear", dev)] is maps


def test_unpinned_module_function_runs_on_card(dev, monkeypatch):
    """A module function called with no device context runs on the card,
    as gridpp_tpu's run on its accelerator; the top-level function stays
    on the host."""
    from gridpp_tpu_torch.api import downscaling as tdown
    from gridpp_tpu_torch.ops import downscaling as tops
    src, tgt, _, vals = _downscale_problem(n_src=(60, 50), n_tgt=200)
    seen = []
    real = tops.bilinear_apply

    def record(values, *maps):
        seen.append((values.device.type, {m.device.type for m in maps}))
        return real(values, *maps)

    monkeypatch.setattr(tops, "bilinear_apply", record)
    got = tdown.bilinear(src, tgt, vals)
    assert seen == [("cuda", {"cuda"})]
    want = gt.bilinear(src, tgt, vals)
    assert seen[1:] == [("cpu", {"cpu"})]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _lr_problem(shape=(949, 739), seed=15):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    z = sum(rng.uniform(0.5, 1) * np.sin(rng.uniform(0.005, 0.05) * yy
                                         + rng.uniform(0.005, 0.05) * xx
                                         + rng.uniform(0, 6))
            for _ in range(6))
    elev = ((z - z.min()) / (z.max() - z.min()) * 2000).astype(np.float32)
    temp = (288 - 0.0065 * elev + rng.normal(0, 2, shape)).astype(np.float32)
    temp[rng.random(shape) < 0.02] = np.nan
    return elev, temp


def test_calc_gradient_lr_on_card_is_five_k1_launches(dev):
    """LinearRegression on the card: four Mean and one Sum launch of K1,
    whose five moments are within K1's bars of the same route's plain
    version on the CPU, and whose gradient is within those bars carried
    through the regression (ROADMAP F9) wherever they fix the variance."""
    from gridpp_tpu_torch.api import gradients as tgrad
    elev, temp = _lr_problem()
    before = stencil.neighbourhood_mean_cuda.launches
    with torch.device(dev):
        got = tgrad.calc_gradient(elev, temp, gt.LinearRegression, 10)
    assert stencil.neighbourhood_mean_cuda.launches - before == 5
    both = np.isfinite(elev) & np.isfinite(temp)
    base, vals = (torch.from_numpy(np.where(both, a, np.nan).astype(
        np.float32)) for a in (elev, temp))
    host = tgrad.lr_moments(base, vals, 10)
    for card, plain in zip(tgrad.lr_moments(base.to(dev), vals.to(dev), 10),
                           host):
        _assert_matches(card, plain, TOL)
    want = tgrad.lr_gradient(base, vals, 10, 2, gt.MV, 0.0).numpy()
    bar, det = lr_bar([m.numpy() for m in host], **TOL)
    d = np.abs(got - want)
    assert (d <= bar + TOL["atol"] + TOL["rtol"] * np.abs(want))[det].all()
    assert det.mean() > 0.99


def test_calc_gradient_minmax_on_card(dev):
    from gridpp_tpu_torch.api import gradients as tgrad
    rng = np.random.default_rng(16)
    base = (rng.integers(0, 5, (300, 260)) * 100).astype(np.float32)
    vals = rng.normal(280, 5, base.shape).astype(np.float32)
    base[rng.random(base.shape) < 0.05] = np.nan
    with torch.device(dev):
        got = tgrad.calc_gradient(base, vals, gt.MinMax, 3)
    assert np.array_equal(got, gt.calc_gradient(base, vals, gt.MinMax, 3),
                          equal_nan=True)


@pytest.mark.parametrize("below,above", [("OneToOne", "MeanSlope"),
                                         ("NearestSlope", "Zero"),
                                         ("Unchanged", "NearestSlope")])
def test_apply_curve_on_card(dev, below, above):
    """apply_curve with a shared 101-knot curve and with per-cell (Y, X,
    11) curves on the card (ops.curves) against the host route (the
    native curve): rtol 1e-6, atol 1e-4."""
    from gridpp_tpu_torch.api import curves as tcurves
    rng = np.random.default_rng(17)
    fcst = rng.normal(280, 8, (1000, 1200)).astype(np.float32)
    fcst[rng.random(fcst.shape) < 0.02] = np.nan
    ref = rng.normal(281, 7, 5000).astype(np.float32)
    cr, cf = gt.quantile_mapping_curve(ref, rng.normal(280, 8, 5000),
                                       np.linspace(0, 1, 101))
    cf, order = np.sort(cf), np.argsort(cf, kind="stable")
    cr = cr[order]
    pf = np.sort(rng.normal(280, 6, fcst.shape + (11,)), axis=-1).astype(
        np.float32)
    pr = np.sort(pf + rng.normal(1, 2, pf.shape), axis=-1).astype(
        np.float32)
    pb, pa = int(getattr(gt, below)), int(getattr(gt, above))
    for curve in ((cr, cf), (pr, pf)):
        with torch.device(dev):
            got = tcurves.apply_curve(fcst, *curve, pb, pa)
        want = gt.apply_curve(fcst, *curve, pb, pa)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
        assert np.array_equal(np.isnan(got), np.isnan(want))


def _cpu_results(fn):
    """Run fn() and return the names of the torch functions that produced a
    CPU tensor in it, other than Tensor.cpu (the final numpy copy), and the
    number of Tensor.cpu calls."""
    from torch.overrides import TorchFunctionMode

    seen, copies = [], []

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", str(func))
            if name == "cpu":
                copies.append(name)
            else:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                        seen.append(name)
            return out

    with Watch():
        fn()
    return seen, len(copies)


def test_device_route_makes_no_cpu_tensor(dev):
    """The downscale -> gradient -> calibrate calls on the card make no
    CPU tensor before their one final copy to the host."""
    from gridpp_tpu_torch.api import curves as tcurves
    from gridpp_tpu_torch.api import downscaling as tdown
    from gridpp_tpu_torch.api import gradients as tgrad
    src, tgt, pts, vals = _downscale_problem(n_src=(60, 50), n_tgt=200)
    elev = src.get_elevs()
    eg = np.full(elev.shape, -0.0065, np.float32)
    curve = (np.linspace(270, 290, 11).astype(np.float32),
             np.linspace(268, 292, 11).astype(np.float32))
    calls = {
        "nearest": lambda: tdown.nearest(src, pts, vals),
        "bilinear": lambda: tdown.bilinear(src, tgt, vals),
        "simple_gradient": lambda: tgrad.simple_gradient(
            src, tgt, vals, -0.0065, gt.Bilinear),
        "full_gradient": lambda: tgrad.full_gradient(
            src, tgt, vals, eg, src.get_lafs() * 0 + 1.0, gt.Bilinear),
        "calc_gradient LR": lambda: tgrad.calc_gradient(
            elev, vals[0], gt.LinearRegression, 3),
        "calc_gradient MinMax": lambda: tgrad.calc_gradient(
            elev, vals[0], gt.MinMax, 3),
        "apply_curve": lambda: tcurves.apply_curve(vals[0], *curve, 0, 0),
    }
    for name, fn in calls.items():
        with torch.device(dev):
            seen, copies = _cpu_results(fn)
        assert not seen and copies == 1, (name, seen, copies)


# -- the rest of gridpp's numpy API: LDC, search, window, masking,
# diagnostics, verification --------------------------------------------------
SLICE_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_api_*.py
PA_TOL = dict(rtol=1e-5, atol=1e-2)
LDC_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_ldc.py:155


def _slice_problem(n=160, p=400, seed=21):
    """A 160 x 160 grid over 59-60N 10-11.5E with relief, 400 stations,
    precipitation (60% dry) with 6 (obs, forecast) pairs a station, an
    80 x 70 ensemble source of 5 members, and the diagnostics' fields."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(59, 60, n), np.linspace(10, 11.5, n),
                             indexing="ij")
    elev = rng.uniform(0, 1500, (n, n)).astype(np.float32)
    laf = np.clip(rng.normal(0.7, 0.4, (n, n)), 0, 1).astype(np.float32)
    grid = gt.Grid(lats, lons, elev, laf)
    pts = gt.Points(rng.uniform(59, 60, p), rng.uniform(10, 11.5, p),
                    rng.uniform(0, 1500, p), rng.uniform(0, 1, p))

    def rain(shape):
        x = rng.gamma(0.8, 3.0, shape).astype(np.float32)
        x[rng.random(shape) < 0.6] = 0.0
        return x

    slats, slons = np.meshgrid(np.linspace(58.9, 60.1, 80),
                               np.linspace(9.9, 11.6, 70), indexing="ij")
    temp = (288 - 0.0065 * elev + rng.normal(0, 2, (n, n))).astype(
        np.float32)
    return dict(
        grid=grid, pts=pts, elev=elev, laf=laf, temp=temp, fc=rain((n, n)),
        obs=rain(p), pobs=rain((6, p)), pbg=rain((6, p)),
        hourly=rain((3000, 24)), src=gt.Grid(slats, slons),
        ens=[rain((80, 70, 5)) for _ in range(3)],
        thr=np.full((n, n), 1.0, np.float32),
        rh=rng.uniform(0.05, 1, (n, n)).astype(np.float32),
        ps=(101325 * np.exp(-elev / 8000.0)).astype(np.float32),
        u=rng.normal(0, 6, (n, n)).astype(np.float32),
        v=rng.normal(0, 6, (n, n)).astype(np.float32),
        knots=gt.Points(rng.uniform(59, 60, 60), rng.uniform(10, 11.5, 60),
                        np.zeros(60), np.zeros(60)))


def _slice_calls(d):
    """name -> (api module, function name, args, bar; None: equal)."""
    from gridpp_tpu_torch.api import diagnostics as tdiag
    from gridpp_tpu_torch.api import ldc as tldc
    from gridpp_tpu_torch.api import masking as tmask
    from gridpp_tpu_torch.api import search as tsearch
    from gridpp_tpu_torch.api import verif as tverif
    from gridpp_tpu_torch.api import window_api as twin
    small = gt.Grid(d["grid"].get_lats()[::4, ::4],
                    d["grid"].get_lons()[::4, ::4])
    return {
        "neighbourhood_score": (tverif, "neighbourhood_score", (
            d["grid"], d["pts"], d["fc"], d["obs"], 5, gt.Ets, 1.0), TOL),
        "neighbourhood_search": (tsearch, "neighbourhood_search", (
            d["temp"], d["laf"], 7, 0.8, 1.0, 0.1), SLICE_TOL),
        "local_distribution_correction": (
            tldc, "local_distribution_correction",
            (d["grid"], d["fc"], d["pts"], d["pobs"], d["pbg"],
             gt.BarnesStructure(5000.0), 0.1, 0.9, 3), LDC_TOL),
        "window Sum": (twin, "window", (d["hourly"], 3, gt.Sum, True),
                       SLICE_TOL),
        "window Max": (twin, "window", (d["hourly"], 5, gt.Max), None),
        "downscale_probability": (tmask, "downscale_probability", (
            d["src"], d["grid"], d["ens"][0], d["thr"], gt.Geq), None),
        "mask_threshold_downscale_consensus": (
            tmask, "mask_threshold_downscale_consensus",
            (d["src"], d["grid"], *d["ens"], d["thr"], gt.Geq, gt.Mean),
            SLICE_TOL),
        "dewpoint": (tdiag, "dewpoint", (d["temp"], d["rh"]), SLICE_TOL),
        "wetbulb": (tdiag, "wetbulb", (d["temp"], d["ps"], d["rh"]),
                    SLICE_TOL),
        "sea_level_pressure": (tdiag, "sea_level_pressure", (
            d["ps"], d["elev"], d["temp"], d["rh"],
            np.full(d["rh"].shape, np.nan, np.float32)), PA_TOL),
        "qnh": (tdiag, "qnh", (d["ps"], d["elev"]), PA_TOL),
        "wind_direction": (tdiag, "wind_direction", (d["u"], d["v"]),
                           SLICE_TOL),
        "smart": (tsearch, "smart", (small, small, d["temp"][::4, ::4], 5,
                                     gt.BarnesStructure(3000.0)), SLICE_TOL),
        "staticcorr_points": (tsearch, "staticcorr_points", (
            d["pts"], d["knots"], gt.BarnesStructure(8000.0), 6), SLICE_TOL),
    }


def test_slice_card_routes_match_host_routes(dev):
    """Each module function on the card against its top-level function (the
    host route: native search, window and LDC, torch on the CPU for the
    rest) at the parity tests' bars."""
    d = _slice_problem()
    for name, (mod, fn, args, tol) in _slice_calls(d).items():
        with torch.device(dev):
            got = getattr(mod, fn)(*args)
        want = getattr(gt, fn)(*args)
        assert got.shape == want.shape and got.dtype == np.float32, name
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        if tol is None:
            assert np.array_equal(got, want, equal_nan=True), name
        elif tol is LDC_TOL:
            _assert_ldc_routes(mod, args, got, want, dev)
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **tol)


class _RhoOn:
    """A structure whose corr_background_torch is evaluated on dev and
    handed back on the caller's device; max_diff: the largest |rho on dev -
    rho on the caller's device|."""

    def __init__(self, structure, dev):
        self.structure, self.dev, self.max_diff = structure, dev, 0.0

    def __getattr__(self, name):
        return getattr(self.structure, name)

    def corr_background_torch(self, p1, p2):
        own = self.structure.corr_background_torch(p1, p2)
        rho = self.structure.corr_background_torch(
            *({k: v.to(self.dev) for k, v in p.items()} for p in (p1, p2)))
        rho = rho.to(own.device)
        if rho.numel():
            self.max_diff = max(self.max_diff,
                                float((rho - own).abs().max()))
        return rho


def _assert_ldc_routes(tldc, args, card, native, dev):
    """ROADMAP F11: the card's rho is within 1e-6 of the CPU's, and on the
    card's rho the device route on the CPU meets the card at LDC_TOL on
    every cell; the card parts past LDC_TOL from the native host route on
    at most twice as many cells as the CPU's device route does."""
    from gridpp_tpu_torch.api import oi as toi
    grid, bg, pts, pobs, pbg, structure, minq, maxq, min_points = args
    bpoints = grid.to_points()
    cand, mask = toi._candidates(bpoints, pts, structure.localization_np(
        bpoints.lats, bpoints.lons), 0)

    def on_cpu(s):
        return tldc._ldc_device(
            bpoints, pts, s, bg.reshape(-1), cand, mask, pobs, pbg, minq,
            maxq, min_points, torch.device("cpu")).reshape(bg.shape)

    def past(a, b):
        return int((~np.isclose(a, b, equal_nan=True, **LDC_TOL)).sum())

    card_rho = _RhoOn(structure, dev)
    np.testing.assert_allclose(card, on_cpu(card_rho), **LDC_TOL)
    assert card_rho.max_diff <= 1e-6
    plain = on_cpu(structure)
    assert past(card, native) <= 2 * past(plain, native)


def test_neighbourhood_score_on_card_is_one_k1_launch(dev):
    """neighbourhood_score smooths its four indicator planes with one K1
    launch, which matches K1's plain version on them at K1's bars."""
    from gridpp_tpu_torch.api import verif as tverif
    d = _slice_problem(n=300, p=900, seed=22)
    for h in (7, 25, 70):
        before = stencil.neighbourhood_mean_cuda.launches
        with torch.device(dev):
            tverif.neighbourhood_score(d["grid"], d["pts"], d["fc"],
                                       d["obs"], h, gt.Kss, 1.0)
        assert stencil.neighbourhood_mean_cuda.launches - before == 1
        planes = torch.as_tensor(tverif.indicator_planes(
            d["grid"], d["pts"], d["fc"], d["obs"], 1.0), device=dev)
        _assert_matches(
            stencil.neighbourhood_mean_cuda(planes, h, h, int(gt.Mean)),
            stencil.neighbourhood_mean_plain(planes, h, h, int(gt.Mean)),
            TOL)


def test_search_and_ldc_card_chunks(dev, monkeypatch):
    """neighbourhood_search's bands and LDC's blocks on the card give the
    one pass's bits."""
    from gridpp_tpu_torch.api import ldc as tldc
    from gridpp_tpu_torch.ops import search as tsearch_ops
    d = _slice_problem(seed=23)
    calls = _slice_calls(d)
    whole = {}
    for name in ("neighbourhood_search", "local_distribution_correction"):
        mod, fn, args, _ = calls[name]
        with torch.device(dev):
            whole[name] = getattr(mod, fn)(*args)
    monkeypatch.setattr(tsearch_ops, "BAND_BYTES", 1)
    monkeypatch.setattr(tldc, "block_rows", lambda k, nt: 333)
    for name in whole:
        mod, fn, args, _ = calls[name]
        with torch.device(dev):
            assert np.array_equal(getattr(mod, fn)(*args), whole[name],
                                  equal_nan=True), name


def test_slice_device_routes_make_no_cpu_tensor(dev):
    """The slice's card routes make no CPU tensor before their one final
    copy to the host."""
    d = _slice_problem(n=96, p=200, seed=24)
    for name, (mod, fn, args, _) in _slice_calls(d).items():
        with torch.device(dev):
            seen, copies = _cpu_results(lambda: getattr(mod, fn)(*args))
        assert not seen and copies == 1, (name, seen, copies)


# -- the numpy neighbourhood API's card route, the parallel layer and the
# command-line client on the card --

@pytest.mark.parametrize("stat", [gt.Mean, gt.Sum, gt.Count, gt.Min, gt.Max,
                                  gt.Std, gt.Variance])
@pytest.mark.parametrize("ens", [False, True])
def test_module_neighbourhood_on_card(dev, stat, ens):
    """api.neighbourhood.neighbourhood called unpinned runs on the card: one
    launch of K1, K2 or K3, equal to its host route at the kernel's bar,
    with no CPU tensor before its one copy down."""
    from gridpp_tpu_torch.api import _common
    from gridpp_tpu_torch.api import neighbourhood as tnb
    x = _field((130, 257, 5) if ens else (130, 257), seed=int(stat))
    wrapper, tol = KERNEL_OF[int(stat)]
    wrapper.launches = 0
    seen, copies = _cpu_results(lambda: tnb.neighbourhood(x, 7, stat))
    assert not seen and copies == 1, (seen, copies)
    assert wrapper.launches == 1
    got = tnb.neighbourhood(x, 7, stat)
    with _common.host():
        want = tnb.neighbourhood(x, 7, stat)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(gt.neighbourhood(x, 7, stat), want)


@pytest.mark.parametrize("quantile", ["scalar", "field"])
@pytest.mark.parametrize("ens", [False, True])
def test_module_quantile_fast_on_card(dev, quantile, ens):
    """api.neighbourhood.neighbourhood_quantile_fast called unpinned runs
    on the card (a 2-D field with one quantile: K4; else the threshold
    planes smoothed by K1) and equals its host route within 1e-5."""
    from gridpp_tpu_torch.api import _common
    from gridpp_tpu_torch.api import neighbourhood as tnb
    x = _field((130, 257, 3) if ens else (130, 257), seed=31)
    thr = gt.get_neighbourhood_thresholds(x, 11)
    q = 0.3 if quantile == "scalar" else np.random.default_rng(2).uniform(
        0, 1, (130, 257)).astype(np.float32)
    stencil.neighbourhood_quantile_fast_cuda.launches = 0
    stencil.neighbourhood_mean_cuda.launches = 0
    got = tnb.neighbourhood_quantile_fast(x, q, 7, thr)
    k4 = not ens and quantile == "scalar"
    assert stencil.neighbourhood_quantile_fast_cuda.launches == int(k4)
    assert stencil.neighbourhood_mean_cuda.launches == int(not k4)
    with _common.host():
        want = tnb.neighbourhood_quantile_fast(x, q, 7, thr)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_distributed_step_on_card(dev):
    """Two gloo ranks whose tiles live on the card (strips staged through
    host buffers), on global_mesh(): the gathered analysis equals the
    one-rank step on the CPU at tests/test_distributed.py:80's bar, and
    each rank launched K1 once."""
    import _torch_parallel_ranks as ranks

    from gridpp_tpu_torch.parallel import make_mesh
    from gridpp_tpu_torch.parallel.dryrun import run_ranks
    got = run_ranks(ranks.host_grid, 2, None, None, timeout=300)
    one = make_mesh(1, device="cpu")
    want = ranks.distributed_step(one, one.block_slices)
    for shape, _, _, _, out, launches in got:
        assert shape == (2, 1) and launches == 1
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-4)


def test_dryrun_multichip_on_card(dev):
    from gridpp_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, timeout=300)


def test_cli_on_card(dev, tmp_path):
    """python -m gridpp_tpu_torch's main on the card against the same argv
    under host(): bilinear rtol 1e-6, atol 1e-4 (equal here), Mean and
    the window at K1's bars, Max and the clamp equal, Std (a 280 K field,
    ROADMAP F14) no further from float64 than the host route; one K1, K2
    and K3 launch a lead."""
    import shutil

    from _torch_cli_files import (VARIABLES, cli_argv, read_outputs,
                                  window_std64, write_files)

    from gridpp_tpu_torch import client
    from gridpp_tpu_torch.api import _common
    write_files(tmp_path / "in.nc", tmp_path / "template.nc")
    outs = {}
    for route in ("card", "host"):
        out = tmp_path / f"out_{route}.nc"
        shutil.copy(tmp_path / "template.nc", out)
        for k in ("mean", "minmax", "var"):
            getattr(stencil, f"neighbourhood_{k}_cuda").launches = 0
        if route == "card":
            assert client.main(cli_argv(tmp_path / "in.nc", out)) == 0
            assert [getattr(stencil, f"neighbourhood_{k}_cuda").launches
                    for k in ("mean", "minmax", "var")] == [3, 3, 3]
        else:
            with _common.host():
                assert client.main(cli_argv(tmp_path / "in.nc", out)) == 0
        outs[route] = read_outputs(out)
    card, host = outs["card"], outs["host"]
    for name, (_, bars) in VARIABLES.items():
        if name == "t_std":
            continue
        if name in ("t_max", "t_qc", "t_bilinear"):
            np.testing.assert_array_equal(card[name], host[name])
        else:
            np.testing.assert_allclose(card[name], host[name],
                                       equal_nan=True, **bars)
    want = window_std64(host["t_bilinear"], 3)
    ok = np.isfinite(want)
    e_card = np.abs(card["t_std"] - want)[ok].max()
    e_host = np.abs(host["t_std"] - want)[ok].max()
    assert e_card <= e_host, (e_card, e_host)
