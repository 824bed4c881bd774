"""gridpp_tpu_torch: gridpp_tpu's serving pipeline in PyTorch and CUDA.

A port of the JAX package gridpp_tpu, which stays the reference. This
package imports torch, numpy and scipy, never jax; it carries its own
copies of the numpy host modules it needs. Ported so far: the serving
`Pipeline` (neighbourhood Mean/Sum/Count smoothing and tiled OI) and the
neighbourhood stencil, whose CUDA kernel (csrc/neighbourhood_mean.cu) is
built with nvcc at its first launch. Importing the package initialises
no CUDA.
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
from .api.pipeline import Pipeline  # noqa: F401
from .ops.neighbourhood import neighbourhood  # noqa: F401
