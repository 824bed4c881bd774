"""The plain versions of kernels K2, K3 and K5 (ops/stencil.py) against
gridpp_tpu's Pallas kernels in interpret mode and its XLA stencil.

Bars (tests/test_pallas_stencil.py): Min/Max exact against XLA and 1e-6
against Pallas (:51); Std/Variance rtol 2e-5, atol 2e-3 (:220); members
rtol 1e-5, atol 1e-4 for Mean/Count and exact for Min/Max (:199). K4's plain
version is ops/neighbourhood.py::_quantile_fast_xla, tested in
tests/test_torch_neighbourhood.py. The kernels themselves are held to these
plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py).

The launch plans are Python and tested here: K4's lanes and groups, K5's
tiling, K1/K2/K3's strips and runs, stencil_plan's route (the one-block
kernel up to each pinned limit, the wide route past it) and K4's guards;
with numpy replays of K4's packed running counts, of the shared-core folds
of the strip kernel and of the wide route, of K1's analytic count and NaN
vote, of K3's whole strip walk (per-op f32 rounding) against its plain
version, and of the wide K4's running and prefix counts against the direct
window counts and its quantiles against the plain version.
"""
import functools
import operator
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gt  # noqa: E402,F401

from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402
from gridpp_tpu_torch.ops import neighbourhood as tops  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _clip(shape, h):
    return min(h, shape[-2] - 1), min(h, shape[-1] - 1)


@pytest.mark.parametrize("stat", [Statistic.Min, Statistic.Max])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((300, 129), 1), ((64, 64), 5),
                                     ((160, 128), 3)])
def test_minmax_plain_matches_pallas(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_minmax_plain(torch.as_tensor(x),
                                             *_clip(shape, h),
                                             int(stat)).numpy()
    xla = np.asarray(jnops._xla_basic(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_minmax(jnp.asarray(x), h, int(stat),
                                                interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((40, 60), 3), ((17, 250), 7),
                                     ((256, 300), 7)])
def test_var_plain_matches_pallas(stat, shape, h):
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_var_plain(torch.as_tensor(x),
                                          *_clip(shape, h),
                                          int(stat)).numpy()
    xla = np.asarray(jnops._xla_basic(jnp.asarray(x), h, int(stat)))
    pallas = np.asarray(ps.neighbourhood_var(jnp.asarray(x), h, int(stat),
                                             interpret=True))
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-3)


def test_var_plain_is_unclamped():
    """E[x^2] - E[x]^2 stays as computed (neighbourhood.cpp:211-235): on a
    constant field its rounding may leave it just below 0, and Std is NaN
    there, in both packages' two-pass form."""
    x = np.full((12, 12), np.float32(0.1), np.float32)
    var = stencil.neighbourhood_var_plain(torch.as_tensor(x), 2, 2,
                                          int(Statistic.Variance)).numpy()
    s = torch.as_tensor(x) * 1.0
    mean = stencil.neighbourhood_mean_plain(s, 2, 2, int(Statistic.Mean))
    mean2 = stencil.neighbourhood_mean_plain(s * s, 2, 2,
                                             int(Statistic.Mean))
    np.testing.assert_array_equal(var, (mean2 - mean * mean).numpy())
    std = stencil.neighbourhood_var_plain(torch.as_tensor(x), 2, 2,
                                          int(Statistic.Std)).numpy()
    np.testing.assert_array_equal(np.isnan(std), var < 0)


MEMBER_TOL = {Statistic.Mean: dict(rtol=1e-5, atol=1e-4),
              Statistic.Count: dict(rtol=1e-5, atol=1e-4),
              Statistic.Sum: dict(rtol=1e-5, atol=1e-4),
              Statistic.Min: dict(rtol=0, atol=0),
              Statistic.Max: dict(rtol=0, atol=0)}


@pytest.mark.parametrize("shape,h", [((40, 60, 4), 3), ((17, 250, 2), 7),
                                     ((31, 31, 6), 0)])
@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Count,
                                  Statistic.Min, Statistic.Max])
def test_members_matches_pallas(shape, h, stat):
    """K5's plain version against gridpp_tpu's member kernel
    (tests/test_pallas_stencil.py:185-199) and its per-member XLA path."""
    x = _field(shape, seed=int(stat) + h)
    got = stencil.neighbourhood_members(torch.as_tensor(x), h,
                                        int(stat)).numpy()
    pallas = np.asarray(ps.neighbourhood_members(jnp.asarray(x), h,
                                                 int(stat), interpret=True))
    per_member = np.stack(
        [np.asarray(jnops._xla_basic(jnp.asarray(x[:, :, k]), h, int(stat)))
         for k in range(shape[2])], axis=2)
    assert got.shape == shape
    np.testing.assert_allclose(got, pallas, **MEMBER_TOL[stat])
    np.testing.assert_allclose(got, per_member, **MEMBER_TOL[stat])


@pytest.mark.parametrize("stat", [Statistic.Sum, Statistic.Max])
def test_members_equal_per_member_planes(stat):
    """Every member of K5's output is K1's or K2's output on that member."""
    x = torch.as_tensor(_field((23, 37, 5), seed=2))
    got = stencil.neighbourhood_members(x, 4, int(stat))
    plain = (stencil.neighbourhood_minmax_plain
             if stat == Statistic.Max else stencil.neighbourhood_mean_plain)
    for k in range(5):
        torch.testing.assert_close(got[:, :, k],
                                   plain(x[:, :, k], 4, 4, int(stat)),
                                   equal_nan=True, rtol=0, atol=0)


def test_members_rejects_what_it_cannot_take():
    x = torch.zeros((8, 9, 3))
    with pytest.raises(ValueError, match="is not Mean"):
        stencil.neighbourhood_members(x, 2, int(Statistic.Std))
    with pytest.raises(ValueError, match=r"\(Y, X, E\)"):
        stencil.neighbourhood_members(x[:, :, 0], 2, int(Statistic.Mean))
    with pytest.raises(ValueError, match="halfwidth"):
        stencil.neighbourhood_members(x, -1, int(Statistic.Mean))
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_members_cuda(x, 2, 2, int(Statistic.Mean))


@pytest.mark.parametrize("fn,stat", [
    (stencil.neighbourhood_minmax_cuda, Statistic.Mean),
    (stencil.neighbourhood_var_cuda, Statistic.Max),
    (stencil.neighbourhood_mean_cuda, Statistic.Std)])
def test_wrappers_reject_other_statistics(fn, stat):
    with pytest.raises(ValueError, match="is not"):
        fn(torch.zeros(8, 8), 1, 1, int(stat))


def test_quantile_fast_wrapper_needs_the_card():
    with pytest.raises(ValueError, match="CUDA tensor"):
        stencil.neighbourhood_quantile_fast_cuda(
            torch.zeros(8, 8), 0.5, 1, 1, torch.linspace(0, 1, 4))


@pytest.mark.parametrize("cells,bits", [(15 * 15, 8), (17 * 17, 16),
                                        (255, 8), (256, 16), (65535, 16),
                                        (65536, 32)])
def test_quantile_fast_lane_width(cells, bits):
    """K4's lanes hold counts up to the window size: 8 bits to 255 cells,
    16 to 65535, else 32 (h=7 packs 4 lanes to a word, h=8 two, as
    gridpp_tpu/ops/pallas_stencil.py:510-512)."""
    assert stencil.qf_lane_bits(cells) == bits
    lanes = 32 // bits
    for t in (1, 3, 4, 5, 11, 12, 33):
        words = stencil.qf_words(t, bits)
        assert words * lanes >= t + 1 > (words - 1) * lanes
        # a lane's largest count, the window size, stays inside the lane
        assert cells < 2 ** bits


@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Max])
@pytest.mark.parametrize("nx", [9, 257, 2000])
def test_member_plan_fits(stat, nx):
    """K5's plan for every E from 1 to 64 and h <= 7: every member in one
    block, tile rows of bx + 2hx columns and an aligned pitch with room
    for the row shift, within the card's 232,448 bytes of shared memory."""
    for e in range(1, 65):
        for h in range(1, 8):
            plan = stencil.member_plan(nx, e, h, h, int(stat))
            assert 1 <= plan.bx <= nx
            assert plan.pitch % 4 == 0
            assert plan.pitch >= (plan.bx + 2 * h) * e + 3
            counts = 2 * stencil.K5_ROWS if stat == Statistic.Mean else 0
            assert plan.smem == (4 * (stencil.K5_ROWS + 2 * h) + counts) \
                * plan.pitch
            assert plan.smem <= stencil.SMEM_LIMIT


def test_member_plan_chunks_members_or_raises():
    """A block takes every member or none: where one grid column of every
    member does not fit (wide halos, many members), the plan raises, and
    stencil_plan sends the call to the wide route on the (Y, X * E) view;
    the tile's size decides exactly where."""
    for e, hy, hx in ((64, 20, 300), (10, 5000, 1), (200, 40, 40)):
        with pytest.raises(ValueError, match="shared memory"):
            stencil.member_plan(2000, e, hy, hx, int(Statistic.Mean))
        plan = stencil.stencil_plan("K5", (6000, 2000, e), hy, hx,
                                    int(Statistic.Mean))
        assert plan.route == "wide"
        assert plan.scratch == stencil.wide_scratch(
            "K5", (6000, 2000, e), int(Statistic.Mean))
    for stat in (Statistic.Mean, Statistic.Max):
        counts = 2 * stencil.K5_ROWS if stat == Statistic.Mean else 0
        for e in (1, 10, 64):
            for hy in range(0, 200, 11):
                for hx in range(0, 200, 13):
                    # one grid column of every member: the smallest tile
                    pitch = -(-((1 + 2 * hx) * e + 3) // 4) * 4
                    fits = (4 * (stencil.K5_ROWS + 2 * hy) + counts) * pitch \
                        <= stencil.SMEM_LIMIT
                    if fits:
                        plan = stencil.member_plan(400, e, hy, hx, int(stat))
                        assert plan.smem <= stencil.SMEM_LIMIT
                    else:
                        with pytest.raises(ValueError, match="shared memory"):
                            stencil.member_plan(400, e, hy, hx, int(stat))


def test_every_kernel_source_is_built():
    """Each csrc/*.cu is one library: a stencil's in stencil.KERNELS, or
    graph_cond.cu, the serving graphs' conditional node (ops/graph.py);
    each C function named there is exported by its source."""
    from gridpp_tpu_torch.ops import graph
    csrc = os.path.join(os.path.dirname(os.path.dirname(stencil.__file__)),
                        "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == sorted(list(stencil.KERNELS) + ["graph_cond"])
    exported = [(name, fn) for name, fn in stencil.KERNELS.items()] + [
        ("graph_cond", fn) for fn in graph.FUNCTIONS]
    for name, fn in exported:
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            assert f"int {fn}(" in f.read()
    with pytest.raises(ValueError, match="no kernel source"):
        stencil.build_kernel("neighbourhood_median")


# -- the route plan (F7) and K1/K2/K3's strip walk ---------------------------
# the largest halfwidth (hy = hx) at which stencil_plan keeps each
# one-block kernel on a 2000-wide grid (K5 with 10 members): the measured
# crossover FUSED_MAX_H; past it the wide route. K4 has only the wide route.
FUSED_LIMITS = [("K1", int(Statistic.Mean), 0, 64),
                ("K2", int(Statistic.Max), 0, 60),
                ("K3", int(Statistic.Std), 0, 83),
                ("K5", int(Statistic.Mean), 0, 10),
                ("K5", int(Statistic.Max), 0, 10)]


def _plan_shape(kernel, n):
    return (n, n, 10) if kernel == "K5" else (n, n)


@pytest.mark.parametrize("kernel,stat,t,limit", FUSED_LIMITS)
def test_stencil_plan_fused_limits(kernel, stat, t, limit):
    """Fused at h=7 and up to the pinned limit, wide past it, on a 2000-wide
    grid; the wide route's scratch is sized from the shape."""
    shape = _plan_shape(kernel, 2000)
    for h in (1, 7, limit):
        plan = stencil.stencil_plan(kernel, shape, h, h, stat, t=t)
        assert plan.route == "fused" and plan.scratch == ()
    assert stencil.FUSED_MAX_H[kernel] == limit
    for h in (limit + 1, 300, 1999):
        plan = stencil.stencil_plan(kernel, shape, h, h, stat, t=t)
        assert plan.route == "wide" and plan.fused is None
        assert plan.scratch == stencil.wide_scratch(kernel, shape, stat, t, h)


@pytest.mark.parametrize("kernel,stat,t,limit", FUSED_LIMITS)
def test_stencil_plan_small_grids(kernel, stat, t, limit):
    """On small grids the clipped halfwidths decide: an 11-wide grid clips
    every h to 10, within every limit (fused); a 400-wide one takes h=7
    fused and h=200 wide."""
    shape = _plan_shape(kernel, 11)
    assert stencil.stencil_plan(kernel, shape, 10, 10, stat, t=t).route == (
        "fused" if 10 <= limit else "wide")
    shape = _plan_shape(kernel, 400)
    assert stencil.stencil_plan(kernel, shape, 7, 7, stat,
                                t=t).route == "fused"
    assert stencil.stencil_plan(kernel, shape, 200, 200, stat,
                                t=t).route == "wide"


@pytest.mark.parametrize("shape,h,t", [((2000, 2000), 0, 11),
                                       ((2000, 2000), 1, 11),
                                       ((2000, 2000), 7, 1),
                                       ((2000, 2000), 7, 33),
                                       ((11, 11), 10, 11),
                                       ((400, 400), 200, 11),
                                       ((2000, 2000), 1999, 5)])
def test_stencil_plan_k4_takes_the_wide_route(shape, h, t):
    """K4 has no one-block kernel: every halfwidth, h=0 included, takes the
    wide route (its running counts cost the same at every h), with the
    scratch of its vertical counts sized from hy."""
    plan = stencil.stencil_plan("K4", shape, h, h, t=t)
    assert plan.route == "wide" and plan.fused is None
    assert plan.scratch == stencil.wide_scratch("K4", shape, None, t, h)
    assert "K4" not in stencil.FUSED_MAX_H


@pytest.mark.parametrize("e", [1, 3, 10, 25, 64])
def test_stencil_plan_k5_takes_whole_members(e):
    """K5's one-block kernel takes every member in one block: up to the
    crossover it is the route wherever member_plan fits, and the wide
    route is taken only where it raises."""
    limit = stencil.FUSED_MAX_H["K5"]
    for nx in (9, 257, 2000):
        for h in range(0, 40, 3):
            hx = min(h, nx - 1)
            plan = stencil.stencil_plan("K5", (300, nx, e), h, hx,
                                        int(Statistic.Mean))
            if plan.route == "fused":
                assert h <= limit
                assert plan.fused == stencil.member_plan(
                    nx, e, h, hx, int(Statistic.Mean))
            elif h <= limit:
                with pytest.raises(ValueError, match="shared memory"):
                    stencil.member_plan(nx, e, h, hx, int(Statistic.Mean))


def test_wide_scratch_sizes():
    n = 3 * 40 * 50
    f32, i32 = torch.float32, torch.int32
    assert stencil.wide_scratch("K1", (3, 40, 50), 0) == ((f32, n), (i32, n))
    assert stencil.wide_scratch("K2", (3, 40, 50), 30) == ((f32, n),)
    assert stencil.wide_scratch("K3", (3, 40, 50), 50) == (
        (f32, n), (f32, n), (i32, n))
    # K4: the vertical counts of 12 lanes, 8 bits while 2hy + 1 (clipped
    # to Y) <= 255, then 16
    assert stencil.wide_scratch("K4", (40, 50), None, 11, 0) == (
        (i32, 3 * 2000),)
    assert stencil.wide_scratch("K4", (40, 50), None, 11, 100) == (
        (i32, 3 * 2000),)
    assert stencil.wide_scratch("K4", (300, 50), None, 11, 200) == (
        (i32, 6 * 15000),)
    assert stencil.wide_scratch("K4", (300, 50), None, 33, 127) == (
        (i32, 9 * 15000),)
    assert stencil.wide_scratch("K5", (40, 50, 7), 80) == (
        (f32, 14000), (i32, 14000))
    with pytest.raises(ValueError, match="no stencil kernel"):
        stencil.stencil_plan("K9", (8, 8), 1, 1)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("shape", [(2000, 2000), (11, 2000, 2000), (1, 500),
                                   (500, 1), (97, 301), (3, 130, 257)])
def test_strip_plan_geometry(shape, kernel):
    """K1/K2/K3's plan: strips of a multiple of 8 columns whose tile row
    fits one round of 256 threads (bw + 2hx <= 128 for hx <= 32), runs of a
    multiple of 16 rows covering the grid, about one wave of blocks where
    the grid allows, and the header's shared-memory formula with the
    kernel's planes of vertical results (K3: three, and still three blocks
    an SM at h=7)."""
    for h in (0, 1, 7, 8, 9, 32, 60, 81):
        hy, hx = min(h, shape[-2] - 1), min(h, shape[-1] - 1)
        plan = stencil.strip_plan(shape, hy, hx, kernel)
        assert plan.bw % 8 == 0 and plan.bw >= 8 and plan.bw <= 128
        if hx <= 32:
            assert plan.bw + 2 * hx <= 128
        assert plan.rows % 16 == 0
        planes = shape[0] if len(shape) == 3 else 1
        strips = -(-shape[-1] // plan.bw)
        runs = -(-shape[-2] // plan.rows)
        assert plan.blocks == strips * runs * planes
        assert (runs - 1) * plan.rows < shape[-2] <= runs * plan.rows
        slots = stencil.H100_SMS * stencil.STRIP_BLOCKS_PER_SM
        if runs > 1:
            assert plan.blocks <= slots
        assert plan.smem == stencil.strip_smem(
            plan.bw, hy, hx, stencil.STRIP_PLANES[kernel])
        assert plan.smem <= stencil.SMEM_LIMIT
    smem = {"K1": 40672, "K2": 32480, "K3": 48864}[kernel]
    assert stencil.strip_plan((2000, 2000), 7, 7, kernel) == \
        stencil.StripPlan(112, 96, 378, smem)
    assert stencil.STRIP_BLOCKS_PER_SM * (smem + 1024) <= stencil.SMEM_PER_SM
    # the first halfwidth whose ring does not fit a block
    first = {"K1": 88, "K2": 92, "K3": 84}[kernel]
    stencil.strip_plan((2000, 2000), first - 1, first - 1, kernel)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.strip_plan((2000, 2000), first, first, kernel)


def _replay_fold(len_, n_out, values, ident=None):
    """fold_half / fold_row_fixed's association (csrc/stencil_strip.cuh) on
    `values` (a list), with op = + and identity `ident` (by default the
    values' type's empty value): the head folded bottom up, the core once,
    the tail top down; direct below n_out terms."""
    if ident is None:
        ident = type(values[0])()
    if len_ < n_out:
        return [functools.reduce(operator.add, values[r:r + len_])
                for r in range(n_out)]
    head = [None] * n_out
    head[n_out - 1] = ident
    head[n_out - 2] = values[n_out - 2]
    for r in range(n_out - 3, -1, -1):
        head[r] = values[r] + head[r + 1]
    core = values[n_out - 1]
    for d in range(n_out, len_):
        core = core + values[d]
    out, tail = [], ident
    for r in range(n_out):
        out.append(core + tail if r == n_out - 1 else head[r] + core + tail)
        if r < n_out - 1:
            tail = values[len_] if r == 0 else tail + values[len_ + r]
    return out


class _Terms(frozenset):
    """A sum as the set of its terms; + asserts each term is added once."""

    def __add__(self, other):
        assert not (self & other), "a term added twice"
        return _Terms(self | other)


@pytest.mark.parametrize("len_", [1, 3, 7, 8, 9, 15, 17, 31, 65, 175])
def test_strip_fold_association_is_the_window(len_):
    """The shared-core fold gives output r exactly the terms r .. r + len -
    1, each once: a direct sum of the window in another association (also
    the horizontal pass above hx = 8, up to K1's largest fused hx, 87)."""
    values = [_Terms({i}) for i in range(len_ + 8)]
    for r, got in enumerate(_replay_fold(len_, 8, values)):
        assert got == set(range(r, r + len_))


def _strip_votes(x, hy, hx, bw):
    """The strip walk's count vote (csrc/stencil_strip.cuh), replayed on its
    strips x0 of bw columns and chunks yc: whether a vertical fold of the
    chunk read more non-finite cells than its NaN padding, which must be
    whether the fold's rows hold a non-finite cell of the domain. Returns
    {(x0, yc): counted}."""
    ny, nx = x.shape
    ch, half = stencil.STRIP_CHUNK, stencil.STRIP_CHUNK // 2
    pad = np.full((ny + 2 * hy + 2 * ch, nx + 2 * hx + bw), np.nan,
                  np.float32)
    pad[hy:hy + ny, hx:hx + nx] = x          # pad[r, c] = x[r - hy, c - hx]
    votes = {}
    for x0 in range(0, nx, bw):
        xs = x0 - hx
        for yc in range(0, ny, ch):
            bad = False
            for k0 in (0, half):
                ytop = yc - hy + k0
                n_rows = half + 2 * hy
                for c in range(bw + 2 * hx):
                    col = pad[ytop + hy:ytop + hy + n_rows, xs + c + hx]
                    nonfinite = int((~np.isfinite(col)).sum())
                    col_in = 0 <= xs + c < nx
                    padding = (n_rows - max(0, min(ytop + n_rows, ny)
                                            - max(ytop, 0))
                               if col_in else n_rows)
                    rows = np.arange(ytop, ytop + n_rows)
                    in_dom = col_in & (rows >= 0) & (rows < ny)
                    truth = bool((~np.isfinite(col) & in_dom).any())
                    assert (nonfinite > padding) == truth
                    bad |= truth
            votes[x0, yc] = bad
    return votes


def _nan_next_to_nan_free(shape, seed, mean=280.0):
    """normal(mean, 5) with NaN at three edges and corners and an inf: most
    chunks see none, their neighbours do."""
    ny, nx = shape
    x = np.random.default_rng(seed).normal(mean, 5, shape).astype(np.float32)
    x[0, 0] = x[ny // 2, nx - 1] = x[ny - 1, nx // 3] = np.nan
    x[min(17, ny - 1), 2] = np.inf
    return x


def _exact_counts(fin, hy, hx):
    """The finite cells of each clipped window, by summed-area tables."""
    ny, nx = fin.shape[:2]
    c = np.zeros((ny + 1, nx + 1) + fin.shape[2:], np.int64)
    c[1:, 1:] = fin.astype(np.int64).cumsum(0).cumsum(1)
    y, x = np.arange(ny), np.arange(nx)
    y0, y1 = np.maximum(y - hy, 0), np.minimum(y + hy, ny - 1) + 1
    x0, x1 = np.maximum(x - hx, 0), np.minimum(x + hx, nx - 1) + 1
    return (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0])


@pytest.mark.parametrize("shape,h", [((37, 150), 3), ((50, 260), 7),
                                     ((90, 9), 7), ((130, 300), 9)])
def test_strip_analytic_count_replay(shape, h):
    """K1's count, replayed in numpy on its strips and chunks: a chunk whose
    vertical folds read more non-finite cells than their NaN padding (the
    kernel's vote) counts; every other chunk takes cy * cx, which must then
    equal the finite cells of each output's window, at the domain edges
    too. NaN sits next to NaN-free chunks and at the corners."""
    ny, nx = shape
    hy, hx = min(h, ny - 1), min(h, nx - 1)
    x = _nan_next_to_nan_free(shape, h)
    plan = stencil.strip_plan(shape, hy, hx, "K1")
    bw, ch = plan.bw, stencil.STRIP_CHUNK
    count = _exact_counts(np.isfinite(x), hy, hx)
    took_analytic = took_counted = 0
    for (x0, yc), bad in _strip_votes(x, hy, hx, bw).items():
        if bad:
            took_counted += 1
            continue
        took_analytic += 1
        for y in range(yc, min(yc + ch, ny)):
            cy = min(y + hy, ny - 1) - max(y - hy, 0) + 1
            for gx in range(x0, min(x0 + bw, nx)):
                cx = min(gx + hx, nx - 1) - max(gx - hx, 0) + 1
                assert cy * cx == count[y, gx]
    assert took_analytic > 0 and took_counted > 0


def _replay_var_strip(x, hy, hx, stat):
    """K3's strip walk (csrc/stencil_strip.cuh, mode kVar) replayed in numpy
    f32, each add and square rounded as __fadd_rn / __fmul_rn round them:
    the vertical pass folds (v, v * v) of each aligned group of 8 output
    rows as head + core + tail, the horizontal pass each aligned group of 8
    outputs the same way (fold_row_fixed's association for hx <= 8,
    fold_half's above: the same), the counts by the vote (analytic, or the
    counted fold's exact integers), then E[x^2] - E[x]^2 with rounded
    divisions. Returns (result, chunks counted, chunks analytic)."""
    ny, nx = x.shape
    half, kout = stencil.STRIP_CHUNK // 2, stencil.STRIP_OUT
    f32 = np.float32
    pad = np.full((ny + 2 * hy + half, nx + 2 * hx + kout), np.nan, f32)
    pad[hy:hy + ny, hx:hx + nx] = x        # the ring: NaN off the domain
    v = np.where(np.isfinite(pad), pad, f32(0))
    sums = []
    for term in (v, v * v):
        vert = np.zeros((ny + half, pad.shape[1]), f32)
        zero = np.zeros(pad.shape[1], f32)
        for y8 in range(0, ny, half):
            vert[y8:y8 + half] = _replay_fold(
                2 * hy + 1, half, [term[y8 + d] for d in range(half + 2 * hy)],
                zero)
        out = np.zeros((ny, nx + kout), f32)
        zero = np.zeros(ny, f32)
        for gx0 in range(0, nx, kout):
            cols = [vert[:ny, gx0 + d] for d in range(kout + 2 * hx)]
            got = _replay_fold(2 * hx + 1, kout, cols, zero)
            out[:, gx0:gx0 + kout] = np.stack(got, axis=1)
        sums.append(out[:, :nx])
    exact = _exact_counts(np.isfinite(x), hy, hx)
    n = np.zeros((ny, nx), f32)
    bw = stencil.strip_plan(x.shape, hy, hx, "K3").bw
    votes = _strip_votes(x, hy, hx, bw)
    ch = stencil.STRIP_CHUNK
    y, xs = np.arange(ny), np.arange(nx)
    cy = np.minimum(y + hy, ny - 1) - np.maximum(y - hy, 0) + 1
    cx = np.minimum(xs + hx, nx - 1) - np.maximum(xs - hx, 0) + 1
    for (x0, yc), counted in votes.items():
        rows, cols = slice(yc, yc + ch), slice(x0, x0 + bw)
        n[rows, cols] = (exact[rows, cols] if counted
                         else cy[rows, None] * cx[None, cols])
    cden = np.maximum(n, f32(1))
    mean, mean2 = sums[0] / cden, sums[1] / cden
    with np.errstate(invalid="ignore"):
        res = mean2 - mean * mean
        if stat == Statistic.Std:
            res = np.sqrt(res)
    res[n == 0] = np.nan
    counted = sum(votes.values())
    return res, counted, len(votes) - counted


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
@pytest.mark.parametrize("shape,h", [((37, 150), 3), ((50, 260), 7),
                                     ((90, 9), 7), ((64, 200), 8),
                                     ((130, 300), 9), ((70, 230), 12)])
def test_strip_var_replay(stat, shape, h):
    """K3 on the strip walk, replayed in numpy (_replay_var_strip) on an
    anomaly field with NaN next to NaN-free chunks and at the corners, for
    hx <= 8 (the register horizontal pass) and hx > 8: within the
    reference's bar (rtol 2e-5, atol 2e-3) of K3's plain version, NaN in
    the same places, with chunks of both counts."""
    ny, nx = shape
    hy, hx = min(h, ny - 1), min(h, nx - 1)
    x = _nan_next_to_nan_free(shape, h, mean=0.0)
    got, counted, analytic = _replay_var_strip(x, hy, hx, stat)
    want = stencil.neighbourhood_var_plain(torch.as_tensor(x), hy, hx,
                                           int(stat)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)
    assert counted > 0 and analytic > 0


def _replay_wide_quantile_counts(x, thr, hy, hx):
    """The wide K4's window counts (csrc/neighbourhood_wide.cu), replayed in
    numpy uint32 arithmetic, which wraps as the kernel's does: the vertical
    pass's packed running counts down runs of 128 rows, each seeded with a
    direct sum, in lanes that hold min(2hy + 1, Y); the horizontal pass's
    chunks of 512 columns, two a thread, each window count the difference
    of block-scanned prefixes with carries from the chunks before, in lanes
    widened to hold the window. Returns the (T + 1, Y, X) lane counts."""
    ny, nx = x.shape
    nl = thr.size + 1
    lt = np.concatenate([[np.inf], thr]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        ind = np.isfinite(x)[..., None] & (x[..., None] <= lt)

    def pack(lanes, bits):
        per = 32 // bits
        out = np.zeros(lanes.shape[:-1] + (-(-nl // per),), np.uint32)
        for lane in range(nl):
            out[..., lane // per] += (lanes[..., lane].astype(np.uint32)
                                      << np.uint32(lane % per * bits))
        return out

    def unpack(words, bits):
        per = 32 // bits
        mask = np.uint32((1 << bits) - 1)
        return np.stack([(words[..., lane // per]
                          >> np.uint32(lane % per * bits)) & mask
                         for lane in range(nl)], axis=-1)

    vbits = stencil.qf_lane_bits(min(2 * hy + 1, ny))
    bits = stencil.qf_lane_bits(min(2 * hy + 1, ny) * min(2 * hx + 1, nx))
    p = pack(ind, vbits)
    v = np.zeros_like(p)
    for y0 in range(0, ny, 128):
        acc = p[max(y0 - hy, 0):min(y0 + hy, ny - 1) + 1].sum(
            axis=0, dtype=np.uint32)
        for y in range(y0, min(y0 + 128, ny)):
            if y > y0 and y + hy < ny:
                acc = acc + p[y + hy]
            if y > y0 and y - hy - 1 >= 0:
                acc = acc - p[y - hy - 1]
            v[y] = acc
    w = pack(unpack(v, vbits), bits)

    def at(c):
        inside = ((c >= 0) & (c < nx))[None, :, None]
        return np.where(inside, w[:, np.clip(c, 0, nx - 1)], np.uint32(0))

    carry_lead = w[:, :hx].sum(axis=1, dtype=np.uint32)
    carry_trail = np.zeros_like(carry_lead)
    counts = np.zeros_like(w)
    for c0 in range(0, nx, 512):
        xa = c0 + 2 * np.arange(256)
        lead_b, trail_b = at(xa + hx + 1), at(xa - hx)
        pre_lead = carry_lead[:, None] + np.cumsum(
            at(xa + hx) + lead_b, axis=1, dtype=np.uint32)
        pre_trail = carry_trail[:, None] + np.cumsum(
            at(xa - hx - 1) + trail_b, axis=1, dtype=np.uint32)
        wb = pre_lead - pre_trail
        for k, cnt in ((0, wb - (lead_b - trail_b)), (1, wb)):
            keep = xa + k < nx
            counts[:, (xa + k)[keep]] = cnt[:, keep]
        carry_lead, carry_trail = pre_lead[:, -1], pre_trail[:, -1]
    return np.moveaxis(unpack(counts, bits), -1, 0)


@pytest.mark.parametrize("shape,h,t", [((150, 560), 3, 11),
                                       ((70, 90), 0, 11),
                                       ((60, 530), 7, 1),
                                       ((260, 560), 120, 5),
                                       ((310, 620), 300, 3),
                                       ((40, 600), 60, 11),
                                       ((300, 40), 500, 33)])
def test_wide_quantile_counts_replay(shape, h, t):
    """The wide K4's running and prefix lane counts, replayed in numpy, at
    h=0, 0 < h < 8, h=120, h=300 (more than 65,535 cells a window) and
    h >= Y - 1 (clipped), with 10% NaN and an all-NaN region: exactly the
    direct window counts; and the quantiles read off them equal to K4's plain
    version (ops/neighbourhood.py::_quantile_fast_xla) bit for bit, NaN
    positions included."""
    rng = np.random.default_rng(h + t)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < 0.1] = np.nan
    x[shape[0] // 4:shape[0] // 2, shape[1] // 3:shape[1] // 2] = np.nan
    thr = np.quantile(x[np.isfinite(x)], np.linspace(0, 1, t)).astype(
        np.float32)
    hy, hx = min(h, shape[0] - 1), min(h, shape[1] - 1)
    got = _replay_wide_quantile_counts(x, thr, hy, hx)
    lt = np.concatenate([[np.inf], thr]).astype(np.float32)
    with np.errstate(invalid="ignore"):
        ind = np.isfinite(x)[..., None] & (x[..., None] <= lt)
    np.testing.assert_array_equal(
        got, np.moveaxis(_exact_counts(ind, hy, hx), -1, 0))
    c = got[0].astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        cdf = np.where(got[0] > 0, got[1:].astype(np.float32)
                       / np.maximum(c, np.float32(1)), np.nan)
    thr_t = torch.as_tensor(thr)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        mine = tops._interp_quantile_tyx(q, torch.as_tensor(cdf), thr_t)
        plain = tops._quantile_fast_xla(torch.as_tensor(x), q, h, thr_t)
        assert torch.equal(torch.isnan(mine), torch.isnan(plain))
        assert torch.equal(torch.nan_to_num(mine), torch.nan_to_num(plain))


def test_quantile_fast_plan_guards():
    """K4's guards, in stencil_plan and so on either route: a clipped window
    of 2^31 cells or more raises, as its counts would not fit the
    epilogue's int32 (a 4097^2 window, past f32's exact integers, and
    46340^2 pass; 46341^2 does not, nor a tall window on a narrow grid);
    thresholds whose carries would not fit a block raise."""
    for shape, hy, hx in (((4097, 4097), 2048, 2048),
                          ((46340, 46340), 23170, 23170)):
        assert stencil.stencil_plan("K4", shape, hy, hx, t=11).route == "wide"
    for shape, hy, hx in (((46341, 46341), 23170, 23170),
                          ((46341, 46341), 46340, 46340),
                          ((3000000, 1000), 1500000, 999)):
        with pytest.raises(ValueError, match="2\\^31"):
            stencil.stencil_plan("K4", shape, hy, hx, t=11)
    with pytest.raises(ValueError, match="thresholds"):
        stencil.stencil_plan("K4", (100, 100), 50, 50, t=20000)


def test_wide_scratch_of_k4_needs_its_halfwidth():
    """K4's vertical counts are as wide as min(2hy + 1, Y) needs, so its
    scratch is sized from hy, which the caller must give."""
    with pytest.raises(ValueError, match="needs hy"):
        stencil.wide_scratch("K4", (300, 400), t=11)


def _replay_wide_fold(n_rows, h, run=16, block=32):
    """wide_fold's rows for each output (csrc/neighbourhood_wide.cu), as
    term sets: runs of `run` outputs, the head folded bottom up, the core
    in blocks of `block` terms, the tail top down, every window clipped to
    rows [0, n_rows)."""
    empty = _Terms()
    row = [_Terms({r}) for r in range(n_rows)]

    def window(lo, hi):
        total, part, k = empty, empty, 0
        for r in range(lo, hi + 1):
            part, k = part + row[r], k + 1
            if k == block or r == hi:
                total, part, k = total + part, empty, 0
        return total

    outs = []
    for r0 in range(0, n_rows, run):
        n_out = min(run, n_rows - r0)
        if 2 * h + 1 < run:
            outs += [window(max(r - h, 0), min(r + h, n_rows - 1))
                     for r in range(r0, r0 + n_out)]
            continue
        head = [empty] * run
        for k in range(run - 2, -1, -1):
            r = r0 + k - h
            head[k] = ((row[r] if r >= 0 else empty) + head[k + 1]
                       if k < n_out - 1 else empty)
        core = window(max(r0 + n_out - 1 - h, 0), min(r0 + h, n_rows - 1))
        tail = empty
        for k in range(n_out):
            if k > 0 and r0 + k + h <= n_rows - 1:
                tail = tail + row[r0 + k + h]
            outs.append(head[k] + core + tail)
    return outs


@pytest.mark.parametrize("n_rows,h", [(40, 7), (40, 8), (37, 30), (5, 100),
                                      (100, 3), (300, 120), (17, 16)])
def test_wide_fold_association_is_the_window(n_rows, h):
    """Each output of the wide route's fold holds exactly the rows of its
    window clipped to the domain, each once, at the domain edges and with
    a partial last run too."""
    for r, got in enumerate(_replay_wide_fold(n_rows, h)):
        assert got == set(range(max(r - h, 0), min(r + h, n_rows - 1) + 1))
