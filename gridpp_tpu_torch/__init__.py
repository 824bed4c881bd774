"""gridpp_tpu_torch: gridpp_tpu's serving pipelines and neighbourhood
statistics in PyTorch and CUDA.

A port of the JAX package gridpp_tpu, which stays the reference. This
package imports torch, numpy and scipy, never jax; it carries its own
copies of the numpy host modules it needs. Ported so far: the serving
`Pipeline` (tiled OI, smoothed with any neighbourhood statistic), the
ensemble serving pipelines `EnsiPipeline` (EnSI, members smoothed by the
member stencil K5) and `MultiEnsiPipeline` (ebe, ebesc, utem) with their
tensor ops (ops/oi_ensi.py, ops/oi_ensi_multi.py), the neighbourhood
statistics on tensors (ops/neighbourhood.py) with their CUDA kernels K1-K5
(csrc/*.cu, built with nvcc at first launch), and gridpp's numpy
neighbourhood API. The top-level names follow gridpp_tpu's: the numpy API
here, the tensor ops under gridpp_tpu_torch.ops. Importing the package
initialises no CUDA.
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
