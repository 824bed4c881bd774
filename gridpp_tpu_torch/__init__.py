"""gridpp_tpu_torch: gridpp_tpu's serving pipelines, optimal interpolation
API and neighbourhood statistics in PyTorch and CUDA.

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
nvcc at first launch), and gridpp's numpy neighbourhood API. The top-level
names follow gridpp_tpu's: the numpy API here, the tensor ops under
gridpp_tpu_torch.ops.

The top-level API functions run on the host (the CPU, with the native C++
OI solvers), as gridpp_tpu's do. The same functions reach the card through
their modules, called under the card as torch's default device:
`with torch.device("cuda"): gridpp_tpu_torch.api.oi.optimal_interpolation(
...)`. Importing the package initialises no CUDA.
"""
from .constants import *  # noqa: F401,F403  (enums, constants, MV)
from .constants import __version__  # noqa: F401
from .core.grid import Grid  # noqa: F401
from .core.point import Point  # noqa: F401
from .core.points import Points  # noqa: F401
from .structure import (  # noqa: F401
    BarnesStructure, CressmanStructure, CrossValidation, LinearStructure,
    MultipleStructure, PowerlawStructure, SoarStructure, StructureFunction,
    ToarStructure)
from .api.utils import calc_even_quantiles, calc_statistic  # noqa: F401
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

# ---- Host pinning ------------------------------------------------------
# The numpy-in/numpy-out API runs on the host (api._common.pin_host), as
# gridpp_tpu's top-level functions run on its XLA:CPU backend.
import types as _types

from .api._common import pin_host as _pin_host

for _name, _obj in list(globals().items()):
    if (isinstance(_obj, _types.FunctionType)
            and not _name.startswith("_")
            and _obj.__module__.startswith("gridpp_tpu_torch.api")):
        globals()[_name] = _pin_host(_obj)
del _name, _obj


def warning(message):
    """Print a warning message (util.cpp:230-232)."""
    print(f"Warning: {message}")
