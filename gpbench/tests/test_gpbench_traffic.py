"""The one traffic generator: the same seed gives the same arrays, and no
two cycles of a window carry equal inputs."""
import numpy as np
import pytest
import torch

from gpbench.harness.traffic import POOL, Traffic
from gpbench.tests import tiny

CELLS = ["det2k_10k.static", "det2k_10k.churn5", "ensi2k_10k_m10.static"]
BIG = 2 ** 31 + 12345          # the driver's seeds pass 32 signed bits


def traffic(name, seed):
    c = tiny.cell(name)
    return Traffic(c.config, c.traffic, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_arrays(name):
    a, b = traffic(name, BIG), traffic(name, BIG)
    np.testing.assert_array_equal(a.plats, b.plats)
    np.testing.assert_array_equal(a.plons, b.plons)
    for i in range(2 * POOL + 1):
        for x, y in zip(a.make(i), b.make(i)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.missing_set(i), b.missing_set(i))


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_other_arrays(name):
    a, b = traffic(name, BIG), traffic(name, BIG + 1)
    assert not np.array_equal(a.plats, b.plats)
    assert not np.array_equal(a.make(0)[0], b.make(0)[0])


@pytest.mark.parametrize("name", CELLS)
def test_no_two_cycles_alike(name):
    t = traffic(name, 7)
    seen = set()
    for i in range(4 * POOL):
        key = b"".join(np.ascontiguousarray(x).tobytes()
                       for x in t.inputs(i))
        assert key not in seen
        seen.add(key)


@pytest.mark.parametrize("name", CELLS)
def test_make_hands_over_what_inputs_gives(name):
    t = traffic(name, 11)
    for i in range(3 * POOL):
        made = [x.copy() for x in t.make(i)]
        for x, y in zip(made, t.inputs(i)):
            np.testing.assert_array_equal(x, y, err_msg=f"cycle {i}")


def test_churn_sets_its_share_missing():
    t = traffic("det2k_10k.churn5", 3)
    p = len(t.plats)
    for i in range(5):
        obs = t.make(i)[1]
        assert np.isnan(obs).sum() == round(0.05 * p)
    assert not np.array_equal(t.missing_set(0), t.missing_set(1))


def test_static_sets_none_missing():
    t = traffic("det2k_10k.static", 3)
    assert all(np.isfinite(t.make(i)[1]).all() for i in range(4))
