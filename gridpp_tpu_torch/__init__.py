"""gridpp_tpu_torch: gridpp_tpu in PyTorch and CUDA: its serving pipelines
and gridpp's whole numpy API.

A port of the JAX package gridpp_tpu, which stays the reference. This
package imports torch, numpy and scipy, never jax; it carries its own
copies of the numpy host modules it needs. Ported so far: the serving
`Pipeline` (tiled OI, smoothed with any neighbourhood statistic), the
ensemble serving pipelines `EnsiPipeline` (EnSI, members smoothed by the
member stencil K5) and `MultiEnsiPipeline` (ebe, ebesc, utem) with their
tensor ops (ops/oi.py, ops/oi_ensi.py, ops/oi_ensi_multi.py), gridpp's OI
numpy API (`optimal_interpolation`, `optimal_interpolation_full`,
`optimal_interpolation_ensi`, `optimal_interpolation_ensi_multi_ebe`,
`_ebesc`, `_utem`), the neighbourhood statistics on tensors
(ops/neighbourhood.py) with their CUDA kernels K1-K5 (csrc/*.cu, built with
nvcc at first launch), gridpp's numpy neighbourhood API, its downscalers
(`nearest`, `bilinear`, `downscaling`: gathers through index maps built
once per grid pair) and elevation gradients (`simple_gradient`,
`full_gradient`, `calc_gradient`, whose LinearRegression on the card is
five K1 launches), its calibration curves (`apply_curve`,
`quantile_mapping_curve`, `monotonize_curve`, the metric optimizer), the
transforms (Identity, Log, BoxCox, StartedBoxCox, Gamma), `KDTree` and
util.cpp's helpers, the local distribution correction, the conditional
neighbourhood search, smart neighbours and static correlations, the
running window, gridding, fill and doping, the ensemble masking
downscalers, the meteorological diagnostics, fuzzy verification
(`neighbourhood_score`, K1 on the card) and the SWIG typemap test
functions; the parallel layer on torch.distributed
(gridpp_tpu_torch.parallel) and the command-line client
(gridpp_tpu_torch.client, `python -m gridpp_tpu_torch`). The top-level
names follow gridpp_tpu's: the numpy API here, the tensor ops under
gridpp_tpu_torch.ops.

The top-level API functions run on the host (the CPU, with the native C++
OI solvers, the LinearRegression gradient and the curves), as gridpp_tpu's
do. The same functions called through their modules run on the card when
there is one, as gridpp_tpu's run on its accelerator:
`gridpp_tpu_torch.api.oi.optimal_interpolation(...)` or
`gridpp_tpu_torch.api.downscaling.bilinear(...)` (on another card under
`with torch.device("cuda:1"):`, on the host under
`gridpp_tpu_torch.api._common.host()`). Importing the package initialises
no CUDA.
"""
from .constants import *  # noqa: F401,F403  (enums, constants, MV)
from .constants import __version__  # noqa: F401
from .core.grid import Grid  # noqa: F401
from .core.kdtree import KDTree  # noqa: F401
from .core.point import Point  # noqa: F401
from .core.points import Points  # noqa: F401
from .structure import (  # noqa: F401
    BarnesStructure, CressmanStructure, CrossValidation, LinearStructure,
    MultipleStructure, PowerlawStructure, SoarStructure, StructureFunction,
    ToarStructure)
from .api.utils import (  # noqa: F401
    calc_even_quantiles, calc_quantile, calc_statistic, compatible_size,
    convert_coordinates, get_lower_index, get_upper_index, init_ivec2,
    init_ivec3, init_vec2, init_vec3, interpolate, is_valid_lat,
    is_valid_lon, num_missing_values, point_in_rectangle)
from .api.downscaling import bilinear, downscaling, nearest  # noqa: F401
from .api.gradients import (  # noqa: F401
    calc_gradient, full_gradient, full_gradient_debug, simple_gradient)
from .api.curves import (  # noqa: F401
    apply_curve, calc_score, get_optimal_threshold, metric_optimizer_curve,
    monotonize_curve, quantile_mapping_curve)
from .api.transform import (  # noqa: F401
    BoxCox, Gamma, Identity, Log, StartedBoxCox, Transform)
from .api.pipeline import (  # noqa: F401
    EnsiPipeline, MultiEnsiPipeline, Pipeline)
from .api.neighbourhood import (  # noqa: F401
    get_neighbourhood_thresholds, neighbourhood, neighbourhood_brute_force,
    neighbourhood_ens, neighbourhood_quantile, neighbourhood_quantile_ens,
    neighbourhood_quantile_ens_fast, neighbourhood_quantile_fast)
from .api.oi import (  # noqa: F401
    optimal_interpolation, optimal_interpolation_full)
from .api.oi_ensi import optimal_interpolation_ensi  # noqa: F401
from .api.oi_ensi_multi import (  # noqa: F401
    optimal_interpolation_ensi_multi_ebe,
    optimal_interpolation_ensi_multi_ebesc,
    optimal_interpolation_ensi_multi_utem)
from .api.diagnostics import (  # noqa: F401
    dewpoint, gamma_inv, pressure, qnh, relative_humidity,
    sea_level_pressure, wetbulb, wind_direction, wind_speed)
from .api.window_api import window  # noqa: F401
from .api.gridding import count, distance, gridding, gridding_nearest  # noqa: F401
from .api.fill import doping_circle, doping_square, fill, fill_missing  # noqa: F401
from .api.masking import (  # noqa: F401
    downscale_probability, mask_threshold_downscale_consensus,
    mask_threshold_downscale_quantile)
from .api.search import neighbourhood_search, smart, staticcorr_points  # noqa: F401
from .api.ldc import local_distribution_correction  # noqa: F401
from .api.verif import (  # noqa: F401
    neighbourhood_score, test_array, test_ivec2_output, test_ivec3_output,
    test_ivec_input, test_ivec_output, test_not_implemented_exception,
    test_vec2_argout, test_vec2_input, test_vec2_output, test_vec3_input,
    test_vec3_output, test_vec_argout, test_vec_input, test_vec_output)

# ---- Host pinning ------------------------------------------------------
# The numpy-in/numpy-out API runs on the host (api._common.pin_host), as
# gridpp_tpu's top-level functions run on its XLA:CPU backend.
import time as _time
import types as _types

from .api._common import pin_host as _pin_host

for _name, _obj in list(globals().items()):
    if (isinstance(_obj, _types.FunctionType)
            and not _name.startswith("_")
            and _obj.__module__.startswith("gridpp_tpu_torch.api")):
        globals()[_name] = _pin_host(_obj)
del _name, _obj

# The span recorder (gridpp_tpu_torch.tracing), which the pipelines load, is
# the port's own module and not one of gridpp_tpu's names: it is left out of
# the package's namespace and found by __getattr__.
import sys as _sys

del tracing


def __getattr__(name):
    if name == "tracing":
        return _sys.modules[__name__ + ".tracing"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# SWIG-style static-method aliases, as in gridpp's bindings
KDTree_calc_distance = KDTree.calc_distance
KDTree_calc_distance_fast = KDTree.calc_distance_fast
KDTree_calc_straight_distance = KDTree.calc_straight_distance
KDTree_deg2rad = KDTree.deg2rad
KDTree_rad2deg = KDTree.rad2deg


def set_omp_threads(num):
    """A no-op kept for gridpp's API: torch manages its threads."""


def get_omp_threads():
    return 0


def initialize_omp():
    """A no-op kept for gridpp's API."""


_debug_level = 0


def set_debug_level(level):
    global _debug_level
    _debug_level = int(level)


def get_debug_level():
    return _debug_level


def clock():
    """Seconds since the epoch (util.cpp's clock)."""
    return _time.time()


def debug(message):
    """Print a debug message (util.cpp:226-228)."""
    print(message)


def warning(message):
    """Print a warning message (util.cpp:230-232)."""
    print(f"Warning: {message}")


def error(message):
    """Print and raise an error (util.cpp:234-245)."""
    print(f"Error: {message}")
    raise RuntimeError(message)


def future_deprecation_warning(function, other=""):
    """Deprecation notice (util.cpp:246-252)."""
    msg = f"Future deprecation warning: {function} will be deprecated"
    msg += f", use {other} instead." if other else "."
    print(msg)
