"""Ensemble mask/threshold downscalers (gridpp_tpu/api/masking.py;
reference src/api/{downscale_probability,
mask_threshold_downscale_consensus}.cpp).

vec3 layout is (Y, X, E), the ensemble axis last. numpy in, numpy out, on
the API's device (api/_common.api_device): the members are gathered at
each output cell's nearest input cell through the nearest map's tensors
that the downscalers cache per (target, device) (api/downscaling.
_map_tensors), then compared and reduced over the members there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import Statistic
from ..core.grid import Grid
from ..ops import stats as stats_ops
from ..ops.downscaling import compare
from ._common import api_device, asarray_f32, upload
from .downscaling import _map_tensors

__all__ = ["downscale_probability", "mask_threshold_downscale_consensus",
           "mask_threshold_downscale_quantile"]


def _nn_gather3(igrid: Grid, ogrid: Grid, values: np.ndarray, dev):
    """(Y, X, E) input gathered at each output cell's nearest input cell:
    (Yo * Xo, E) on dev."""
    (flat,) = _map_tensors(igrid, "nearest", ogrid, dev, lambda: (
        igrid.nearest_map(ogrid.lats, ogrid.lons),))
    gy, gx = igrid.size()
    v = upload(values, dev).reshape(gy * gx, -1)
    return torch.index_select(v, 0, flat.reshape(-1))


def downscale_probability(igrid, ogrid, ivalues, threshold,
                          comparison_operator):
    """NN-downscaled ensemble exceedance probability
    (downscale_probability.cpp:7-64)."""
    ivalues = asarray_f32(ivalues)
    if ivalues.ndim != 3:
        raise ValueError("values must be 3D (Y, X, E)")
    threshold = asarray_f32(threshold, "threshold")
    oy, ox = ogrid.size()
    if threshold.shape != (oy, ox):
        raise ValueError("Threshold must be the same size as the output grid")
    dev = api_device()
    g = _nn_gather3(igrid, ogrid, ivalues, dev)  # (Yo*Xo, E)
    valid = torch.isfinite(g)
    hit = compare(g, upload(threshold.reshape(-1, 1), dev),
                  int(comparison_operator))
    count = torch.sum(valid, dim=1)
    total = torch.sum(hit & valid, dim=1)
    # the share in float64 then f32, as gridpp_tpu's numpy divides
    prob = torch.where(count > 0, total.to(torch.float64)
                       / torch.clamp(count, min=1).to(torch.float64),
                       torch.nan)
    return prob.to(torch.float32).cpu().numpy().reshape(oy, ox)


def _mask_threshold(igrid, ogrid, ivalues_true, ivalues_false,
                    threshold_values, threshold, comparison_operator,
                    statistic, quantile):
    ivalues_true = asarray_f32(ivalues_true, "ivalues_true")
    ivalues_false = asarray_f32(ivalues_false, "ivalues_false")
    threshold_values = asarray_f32(threshold_values, "threshold_values")
    threshold = asarray_f32(threshold, "threshold")
    for v in (ivalues_true, ivalues_false, threshold_values):
        if v.ndim != 3:
            raise ValueError("values must be 3D (Y, X, E)")
    oy, ox = ogrid.size()
    dev = api_device()
    gt, gf, gthr = (_nn_gather3(igrid, ogrid, v, dev)
                    for v in (ivalues_true, ivalues_false, threshold_values))
    hit = compare(gthr, upload(threshold.reshape(-1, 1), dev),
                  int(comparison_operator))
    masked = torch.where(torch.isfinite(gthr), torch.where(hit, gt, gf),
                         torch.nan)
    statistic = int(statistic)
    if statistic == Statistic.Quantile:
        out = stats_ops.nan_quantile(masked, float(quantile), axis=-1)
    else:
        out = stats_ops.nan_statistic(masked, statistic, axis=-1)
    return out.cpu().numpy().reshape(oy, ox)


def mask_threshold_downscale_consensus(igrid, ogrid, ivalues_true,
                                       ivalues_false, threshold_values,
                                       threshold, comparison_operator,
                                       statistic):
    """Per-member true/false selection + statistic reduce
    (mask_threshold_downscale_consensus.cpp:19-83)."""
    return _mask_threshold(igrid, ogrid, ivalues_true, ivalues_false,
                           threshold_values, threshold, comparison_operator,
                           statistic, 0.0)


def mask_threshold_downscale_quantile(igrid, ogrid, ivalues_true,
                                      ivalues_false, threshold_values,
                                      threshold, comparison_operator,
                                      quantile_level):
    return _mask_threshold(igrid, ogrid, ivalues_true, ivalues_false,
                           threshold_values, threshold, comparison_operator,
                           Statistic.Quantile, float(quantile_level))
