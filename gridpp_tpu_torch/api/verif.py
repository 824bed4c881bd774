"""neighbourhood_score, fuzzy verification (gridpp_tpu/api/verif.py;
reference src/api/neighbourhood_score.cpp), and the binding-parity test
functions (reference src/api/swig.cpp, which the reference's typemap tests
call).

neighbourhood_score grids the reference points onto the grid (the host's
nearest scatter, api/gridding.gridding_nearest), forms the four
contingency indicator planes, smooths them with the neighbourhood Mean on
the API's device (api/_common.api_device), one call on the stacked (4, Y,
X) planes: one launch of kernel K1 on the card, which computes each plane
alone, its plain version on the CPU; then scores them (ops/curves.
calc_score).
"""
from __future__ import annotations

import numpy as np

from ..constants import Statistic, swig_default_value
from ..ops import curves as curve_ops
from ..ops import neighbourhood as nops
from ._common import api_device, asarray_f32, check_grid_compatible, upload
from .gridding import gridding_nearest

__all__ = ["neighbourhood_score"]


def indicator_planes(grid, points, fcst, ref, threshold):
    """The (4, Y, X) f32 contingency indicators of fcst (Y, X) against the
    reference points gridded to their nearest cells (hits, false alarms,
    misses, correct negatives), 0 where either is missing."""
    ref_grid = gridding_nearest(grid, points, ref, 1, Statistic.Mean)
    both = np.isfinite(ref_grid) & np.isfinite(fcst)
    fpos = fcst > threshold
    rpos = ref_grid > threshold
    return np.stack([both & fpos & rpos, both & fpos & ~rpos,
                     both & ~fpos & rpos, both & ~fpos & ~rpos]
                    ).astype(np.float32)


def neighbourhood_score(grid, points, fcst, ref, half_width, metric,
                        threshold):
    """Fuzzy neighbourhood verification score per cell
    (neighbourhood_score.cpp:6-60)."""
    fcst = asarray_f32(fcst)
    check_grid_compatible(grid, fcst)
    if half_width <= 0:
        raise ValueError("half_width must be greater than 0")
    planes = indicator_planes(grid, points, fcst, ref, threshold)
    smooth = nops.neighbourhood(upload(planes, api_device()),
                                int(half_width), Statistic.Mean)
    out = curve_ops.calc_score(*smooth, int(metric))
    return out.cpu().numpy()


# --- binding-parity test functions (swig.cpp) --------------------------
def test_vec_input(input):
    return float(np.sum(np.asarray(input, np.float32)))


def test_ivec_input(input):
    return int(np.sum(np.asarray(input, np.int64)))


def test_vec2_input(input):
    return float(np.sum(np.asarray(input, np.float32)))


def test_vec3_input(input):
    return float(np.sum(np.asarray(input, np.float32)))


def test_vec_output():
    return np.full(3, swig_default_value, np.float32)


def test_vec2_output():
    return np.full((3, 3), swig_default_value, np.float32)


def test_vec3_output():
    return np.full((3, 3, 3), swig_default_value, np.float32)


def test_ivec_output():
    return np.full(3, int(swig_default_value), np.int32)


def test_ivec2_output():
    return np.full((3, 3), int(swig_default_value), np.int32)


def test_ivec3_output():
    return np.full((3, 3, 3), int(swig_default_value), np.int32)


def test_vec_argout():
    return 0.0, np.full(10, swig_default_value, np.float32)


def test_vec2_argout():
    return 0.0, np.full((10, 10), swig_default_value, np.float32)


def test_array(v, n=None):
    """Identity over a raw array (swig.cpp:6-11, coverage-only)."""
    return np.asarray(v, np.float32)


def test_not_implemented_exception():
    raise NotImplementedError("Not implemented")
