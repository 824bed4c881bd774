"""The plain versions of kernels K2, K3 and K5 (ops/stencil.py) against
gridpp_tpu's Pallas kernels in interpret mode and its XLA stencil.

Bars (tests/test_pallas_stencil.py): Min/Max exact against XLA and 1e-6
against Pallas (:51); Std/Variance rtol 2e-5, atol 2e-3 (:220); members
rtol 1e-5, atol 1e-4 for Mean/Count and exact for Min/Max (:199). K4's plain
version is ops/neighbourhood.py::_quantile_fast_xla, tested in
tests/test_torch_neighbourhood.py. The kernels themselves are held to these
plain versions on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gt  # noqa: E402,F401

from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402
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


@pytest.mark.parametrize("h,t,words,single", [(7, 11, 3, True),
                                              (7, 15, 4, True),
                                              (7, 16, 5, False),
                                              (8, 11, 6, False),
                                              (8, 7, 4, True),
                                              (7, 1, 1, True),
                                              (0, 11, 3, True),
                                              (88, 33, 17, False)])
def test_quantile_fast_plan(h, t, words, single):
    plan = stencil.qf_plan(h, h, t)
    assert plan.words == words and (plan.group >= words) == single
    assert plan.bits == stencil.qf_lane_bits((2 * h + 1) ** 2)
    assert plan.group in (1, 2, 4)
    tw = stencil.QF_BX + 2 * h
    assert plan.pitch >= tw
    tile = max((stencil.QF_BY + 2 * h) * tw,
               stencil.QF_BY * (stencil.QF_BX + 1))
    assert plan.smem == 4 * (tile + plan.group * stencil.QF_BY * plan.pitch)
    assert plan.smem <= stencil.SMEM_LIMIT


def test_quantile_fast_plan_takes_every_halfwidth_it_took_before():
    """A per-threshold K4 takes a tile plus one plane of vertical counts:
    (32 + 2hy) x (64 + 2hx) + 32 x (64 + 2hx) floats; the plan takes at
    least those halfwidths and raises the same shared-memory error past
    them."""
    for hy in range(0, 200, 7):
        for hx in range(0, 200, 9):
            old = 4 * ((32 + 2 * hy) + 32) * (64 + 2 * hx)
            if old <= stencil.SMEM_LIMIT:
                assert stencil.qf_plan(hy, hx, 11).smem <= stencil.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        stencil.qf_plan(89, 89, 5)


@pytest.mark.parametrize("stat", [Statistic.Mean, Statistic.Max])
@pytest.mark.parametrize("nx", [9, 257, 2000])
def test_member_plan_fits(stat, nx):
    """K5's plan for every E from 1 to 64 and h <= 7: all members in one
    block where the tile fits, tile rows of bx + 2hx columns and an
    aligned pitch with room for the row shift, within the card's 232,448
    bytes of shared memory."""
    for e in range(1, 65):
        for h in range(1, 8):
            plan = stencil.member_plan(nx, e, h, h, int(stat))
            assert 1 <= plan.chunk <= e and 1 <= plan.bx <= nx
            assert plan.pitch % 4 == 0
            assert plan.pitch >= (plan.bx + 2 * h) * plan.chunk + 3
            counts = 2 * stencil.K5_ROWS if stat == Statistic.Mean else 0
            assert plan.smem == (4 * (stencil.K5_ROWS + 2 * h) + counts) \
                * plan.pitch
            assert plan.smem <= stencil.SMEM_LIMIT
            assert plan.chunk == e  # h <= 7 never needs a member chunk


def test_member_plan_chunks_members_or_raises():
    """Wide halos take fewer members a block, down to one member of one
    grid column; past that the plan raises, as K1 on the member layout
    did where its tile did not fit."""
    plan = stencil.member_plan(2000, 64, 20, 300, int(Statistic.Mean))
    assert plan.chunk < 64 and plan.smem <= stencil.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        stencil.member_plan(10, 3, 5000, 1, int(Statistic.Mean))
    for hy in range(0, 200, 11):
        for hx in range(0, 200, 13):
            old = 4 * (32 + 2 * hy + 64) * (64 + 2 * hx)  # K1 on one member
            if old <= stencil.SMEM_LIMIT:
                assert stencil.member_plan(
                    400, 10, hy, hx, int(Statistic.Mean)).smem \
                    <= stencil.SMEM_LIMIT


def test_quantile_fast_packed_running_counts():
    """K4's packed arithmetic, replayed in numpy: indicator lanes packed
    into int32 words, window-summed with running adds and subtracts along
    both axes, unpack to the direct per-threshold window counts."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (30, 41)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    thr = rng.normal(0, 1, 11).astype(np.float32)
    hy, hx = 3, 5
    bits = stencil.qf_lane_bits((2 * hy + 1) * (2 * hx + 1))
    lanes = 32 // bits
    words = stencil.qf_words(thr.size, bits)
    lane_thr = np.full(words * lanes, np.nan, np.float32)
    lane_thr[0] = np.inf
    lane_thr[1:thr.size + 1] = thr
    with np.errstate(invalid="ignore"):
        ind = np.isfinite(x)[..., None] & (x[..., None] <= lane_thr)
    shift = (np.arange(words * lanes) % lanes) * bits
    packed = np.zeros(x.shape + (words,), np.uint32)
    for lane in range(words * lanes):
        packed[..., lane // lanes] += (ind[..., lane].astype(np.uint32)
                                       << np.uint32(shift[lane]))
    pad = np.zeros((x.shape[0] + 2 * hy, x.shape[1] + 2 * hx, words),
                   np.uint32)
    pad[hy:hy + x.shape[0], hx:hx + x.shape[1]] = packed
    vert = np.zeros((x.shape[0], pad.shape[1], words), np.uint32)
    acc = pad[:2 * hy + 1].sum(axis=0, dtype=np.uint32)
    vert[0] = acc
    for r in range(1, x.shape[0]):
        acc = acc + pad[r + 2 * hy] - pad[r - 1]
        vert[r] = acc
    win = np.zeros(x.shape + (words,), np.uint32)
    acc = vert[:, :2 * hx + 1].sum(axis=1, dtype=np.uint32)
    win[:, 0] = acc
    for c in range(1, x.shape[1]):
        acc = acc + vert[:, c + 2 * hx] - vert[:, c - 1]
        win[:, c] = acc
    mask = np.uint32((1 << bits) - 1)
    ipad = np.zeros((x.shape[0] + 2 * hy, x.shape[1] + 2 * hx,
                     words * lanes), np.int64)
    ipad[hy:hy + x.shape[0], hx:hx + x.shape[1]] = ind
    for lane in range(thr.size + 1):
        got = (win[..., lane // lanes] >> np.uint32(shift[lane])) & mask
        want = sum(ipad[dy:dy + x.shape[0], dx:dx + x.shape[1], lane]
                   for dy in range(2 * hy + 1) for dx in range(2 * hx + 1))
        np.testing.assert_array_equal(got, want)


def test_every_kernel_source_is_built():
    """Each csrc/*.cu is one library in stencil.KERNELS, and each launch
    function named there is exported by its source."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(stencil.__file__)),
                        "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == sorted(stencil.KERNELS)
    for name, fn in stencil.KERNELS.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            assert f"int {fn}(" in f.read()
    with pytest.raises(ValueError, match="no kernel source"):
        stencil.build_kernel("neighbourhood_median")
