"""Multi-rank execution on torch.distributed: rank meshes, halo exchange,
sharded pipelines (gridpp_tpu/parallel)."""
from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    sharded_neighbourhood, sharded_oi_kernel,
)
