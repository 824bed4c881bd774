"""corr_torch against gridpp_tpu's corr_jnp for every structure kernel.

Same seeded field dicts into both; missing elevations and lafs included,
so the skip rules of the vertical and laf factors are exercised. rtol 1e-6
allows the few-ulp differences between XLA's and torch's exp.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_helpers import gj, gt, tensor  # noqa: E402

STRUCTURES = [
    ("BarnesStructure", (30000.0, 200.0, 0.5)),
    ("BarnesStructure", (30000.0, 200.0, 0.5, 60000.0)),
    ("CressmanStructure", (40000.0, 300.0, 0.6)),
    ("SoarStructure", (25000.0, 150.0, 0.4)),
    ("ToarStructure", (25000.0, 150.0, 0.4)),
    ("PowerlawStructure", (20000.0, 100.0, 0.3)),
    ("LinearStructure", (0.5, 0.3, 0.2)),
]


def _fields(seed, n, m):
    rng = np.random.default_rng(seed)
    # half the points in a 10 km cluster, half spread over 2000 km, so
    # every kernel sees pairs inside and beyond its localization
    scale = np.where(rng.random(n + m) < 0.5, 1e4, 2e6)[:, None]
    xyz = (rng.normal(0, 1, (n + m, 3)) * scale).astype(np.float32)
    xyz[n] = xyz[0]  # one coincident pair (the Linear kernel's only hit)
    elev = rng.uniform(0, 800, n + m).astype(np.float32)
    laf = rng.uniform(0, 1, n + m).astype(np.float32)
    elev[rng.random(n + m) < 0.2] = np.nan
    laf[rng.random(n + m) < 0.2] = np.nan
    f = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2], "elev": elev,
         "laf": laf}
    p1 = {k: v[:n, None] for k, v in f.items()}
    p2 = {k: v[None, n:] for k, v in f.items()}
    return p1, p2


def _pair(kind, args):
    return getattr(gj, kind)(*args), getattr(gt, kind)(*args)


def _compare(sj, st, seed=0):
    p1, p2 = _fields(seed, 24, 40)
    want = np.asarray(sj.corr_jnp({k: jnp.asarray(v) for k, v in p1.items()},
                                  {k: jnp.asarray(v) for k, v in p2.items()}))
    got = st.corr_torch({k: tensor(v) for k, v in p1.items()},
                        {k: tensor(v) for k, v in p2.items()}).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    return want


@pytest.mark.parametrize("kind,args", STRUCTURES)
def test_corr_torch_matches_corr_jnp(kind, args):
    want = _compare(*_pair(kind, args))
    if kind != "LinearStructure":
        assert (want > 0).any() and (want == 0).any()


def test_multiple_and_cross_validation():
    hj, ht = _pair("BarnesStructure", (30000.0, 0.0, 0.0))
    vj, vt = _pair("SoarStructure", (1.0, 200.0, 0.0))
    wj, wt = _pair("CressmanStructure", (1.0, 0.0, 0.5))
    _compare(gj.MultipleStructure(hj, vj, wj),
             gt.MultipleStructure(ht, vt, wt))
    _compare(gj.CrossValidation(hj, 5000.0), gt.CrossValidation(ht, 5000.0))


def test_zero_scales_disable_factors():
    _compare(*_pair("BarnesStructure", (30000.0, 0.0, 0.0)), seed=3)
    _compare(*_pair("CressmanStructure", (40000.0, 0.0, 0.0)), seed=4)
