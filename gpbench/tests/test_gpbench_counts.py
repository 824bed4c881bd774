"""The frozen counts: each configuration's cycle bound against its
formula at a tiny shape, the K1 byte rule and the peaks' lookup."""
import pytest

from gpbench.counts import peaks
from gpbench.harness import manifest

TINY = {"grid": {"ny": 3, "nx": 5}, "stations": 7, "max_points": 2,
        "candidates": 4, "members": 3}


def test_det_bound_static_and_churned():
    n, s, k, p = 15, 2, 4, 7
    count = manifest.counts("det2k_10k")
    nbytes, ops = count.cycle(TINY, {"missing_fraction": 0.0})
    assert nbytes == 4 * n + 4 * n + 8 * p + 8 * n * s
    assert ops == 2 * n * s
    nbytes2, ops2 = count.cycle(TINY, {"missing_fraction": 0.05})
    assert nbytes2 == nbytes + 8 * n * k + 8 * n * s
    assert ops2 == pytest.approx(ops + n * (11 * s * (s - 1) / 2
                                            + s ** 3 / 3 + 2 * s * s))


def test_ensi_bound():
    n, e, s, k, p = 15, 3, 2, 4, 7
    count = manifest.counts("ensi2k_10k_m10")
    nbytes, ops = count.cycle(TINY, {"missing_fraction": 0.0})
    assert nbytes == 8 * n * e + 8 * p + 8 * n * s + 4 * p * e
    assert ops == n * (e * s + 2 * e * e * s + e ** 3 + 2 * e * s
                       + 4 * e * e + 4 * e)
    nbytes2, _ = count.cycle(TINY, {"missing_fraction": 0.05})
    assert nbytes2 == nbytes + 8 * n * (k - s)


def test_full_size_bounds():
    """The issue's figure: det2k_10k static about 352 MB, bytes-bound."""
    cfg = manifest.read_json(manifest.path("configs", "det2k_10k.json"))
    nbytes, ops = manifest.counts("det2k_10k").cycle(
        cfg, {"missing_fraction": 0.0})
    assert nbytes == 352_080_000
    h100 = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert peaks.bound_s(nbytes, ops, h100) == pytest.approx(
        nbytes / 3.35e12)


def test_k1_bytes_and_peaks():
    assert peaks.k1_bytes(2000, 2000) == 32_000_000
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["bytes"] == 3.35e12
    assert peaks.peaks("NVIDIA H100 NVL")["bytes"] == 3.9e12
    assert peaks.peaks("NVIDIA A100-SXM4-80GB") is None
