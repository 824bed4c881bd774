"""K3's plain version against torch's thread count and against float64
(ROADMAP F15: a one-off miss of `test_var_plain_matches_pallas
[shape0-3-50]` against the Pallas kernel, 29 of 2,400 cells up to 3.1e-3
off, in one full xdist run).

The port's side gives the same bits under 1, 2, 6 and the default thread
count, and each of the three sides (the port's plain version, gridpp_tpu's
`_xla_basic`, its Pallas kernel in interpret mode) is held on its own to a
float64 E[x^2] - E[x]^2 at tests/test_pallas_stencil.py:220's bar, so that
a recurrence names the side that moved.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.ops import pallas_stencil as ps  # noqa: E402

from gridpp_tpu_torch.constants import Statistic  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402

RTOL, ATOL = 2e-5, 2e-3  # tests/test_pallas_stencil.py:220
SHAPE, H = (40, 60), 3


def _field(seed):
    """tests/test_torch_stencils.py::_field: normal(0, 10), 10% NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, SHAPE).astype(np.float32)
    x[rng.random(SHAPE) < 0.1] = np.nan
    return x


def _float64(x, h, stat):
    """E[x^2] - E[x]^2 over each clipped window's finite cells, in
    float64."""
    ok = np.isfinite(x)
    v = np.where(ok, x, 0.0).astype(np.float64)
    ny, nx = x.shape
    out = np.empty((ny, nx))
    for i in range(ny):
        for j in range(nx):
            win = (slice(max(i - h, 0), i + h + 1),
                   slice(max(j - h, 0), j + h + 1))
            c = ok[win].sum()
            var = (v[win] ** 2).sum() / c - (v[win].sum() / c) ** 2
            out[i, j] = np.sqrt(var) if stat == Statistic.Std else var
    return out


def _port(x, stat):
    return stencil.neighbourhood_var_plain(torch.as_tensor(x), H, H,
                                           int(stat)).numpy()


@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
def test_var_plain_same_bits_under_thread_counts(stat):
    x = _field(int(stat) + H)
    before = torch.get_num_threads()
    try:
        outs = {}
        for n in (1, 2, 6, before):
            torch.set_num_threads(n)
            outs[n] = _port(x, stat)
    finally:
        torch.set_num_threads(before)
    for n, out in outs.items():
        np.testing.assert_array_equal(out, outs[1], err_msg=f"{n} threads")


@pytest.mark.parametrize("side", ["port", "xla", "pallas"])
@pytest.mark.parametrize("stat", [Statistic.Std, Statistic.Variance])
def test_var_sides_against_float64(stat, side):
    x = _field(int(stat) + H)
    got = {
        "port": lambda: _port(x, stat),
        "xla": lambda: np.asarray(jnops._xla_basic(jnp.asarray(x), H,
                                                   int(stat))),
        "pallas": lambda: np.asarray(ps.neighbourhood_var(
            jnp.asarray(x), H, int(stat), interpret=True)),
    }[side]()
    np.testing.assert_allclose(got, _float64(x, H, stat), rtol=RTOL,
                               atol=ATOL)
