"""Command-line client: NetCDF post-processing pipeline.

gridpp_tpu's client (gridpp_tpu/client), run as `python -m
gridpp_tpu_torch`: a re-design of the reference CLI (reference
src/client/) with the same `gridpp inputs outputs -v var -d downscaler -c
calibrator -p parameters` command structure, built directly on the port's
library API instead of a second operator hierarchy. Every call that has a
card route goes to its module function (api.downscaling, api.neighbourhood,
...), which runs on the card when there is one; under
`gridpp_tpu_torch.api._common.host()` the whole client runs on the CPU.
NetCDF3 I/O via scipy; NetCDF4 files require the optional netCDF4 package.
"""
from .driver import main  # noqa: F401
