"""Downscaling on tensors: gathers and blends (gridpp_tpu/ops/downscaling.py).

The reference's nearest and bilinear downscalers look up an R-tree per
output cell inside an OpenMP loop (reference nearest.cpp:20-69,
bilinear.cpp:43-52). Here every spatial search happens once, on the host
(core/index.py, core/bilinear_weights.py); these functions are the apply
step: gathers over the flattened trailing (Y, X) axes, batched over any
leading axes (time, ensemble), on whatever device the tensors lie. They
are torch ops, as they are XLA ops in gridpp_tpu, not a kernel port.
"""
from __future__ import annotations

import torch

from ..constants import ComparisonOperator

__all__ = ["gather_flat", "nearest_apply", "bilinear_apply",
           "downscale_probability_apply", "compare"]


def gather_flat(values: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """Gather along the flattened trailing (Y, X) axes.

    values: (..., Y, X); flat_idx: an int32 or int64 tensor of any shape N*.
    Returns (..., *N): the trailing spatial axes replaced by N*'s shape.
    """
    lead = values.shape[:-2]
    flatv = values.reshape(lead + (-1,))
    out = torch.index_select(flatv, -1, flat_idx.reshape(-1))
    return out.reshape(lead + flat_idx.shape)


def nearest_apply(values: torch.Tensor,
                  flat_idx: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour downscale (nearest.cpp) as one gather."""
    return gather_flat(values, flat_idx)


def bilinear_apply(values, p1, p2, p3, p4, nn, s, t, inside):
    """Bilinear blend with the nearest-neighbour fallback (bilinear.cpp:
    262-330): P1 (1-s)(1-t) + P2 s(1-t) + P3 (1-s) t + P4 s t in f32, the
    nearest neighbour where a corner is not finite or the point lies
    outside the domain. values: (..., Y, X); the index and weight tensors
    share one shape N*."""
    v1 = gather_flat(values, p1)
    v2 = gather_flat(values, p2)
    v3 = gather_flat(values, p3)
    v4 = gather_flat(values, p4)
    vnn = gather_flat(values, nn)
    blend = (v1 * (1 - s) * (1 - t) + v2 * s * (1 - t)
             + v3 * (1 - s) * t + v4 * s * t)
    corners_valid = (torch.isfinite(v1) & torch.isfinite(v2)
                     & torch.isfinite(v3) & torch.isfinite(v4))
    return torch.where(inside & corners_valid, blend, vnn)


def downscale_probability_apply(values, flat_idx, threshold,
                                comparison: int):
    """Nearest-neighbour downscaled ensemble exceedance probability
    (downscale_probability.cpp:7-64): the share of the valid members at
    the nearest input cell that satisfy the comparison with the output
    cell's threshold; NaN where no member is valid.
    values: (E, Y, X); flat_idx and threshold: the output's shape."""
    g = gather_flat(values, flat_idx)  # (E, *out)
    valid = torch.isfinite(g)
    hit = compare(g, threshold, comparison)
    num = torch.sum(hit & valid, dim=0).to(values.dtype)
    den = torch.sum(valid, dim=0)
    return torch.where(den > 0, num / torch.clamp(den, min=1), torch.nan)


def compare(values, threshold, comparison: int):
    """Elementwise ComparisonOperator evaluation."""
    comparison = int(comparison)
    if comparison == ComparisonOperator.Lt:
        return values < threshold
    if comparison == ComparisonOperator.Leq:
        return values <= threshold
    if comparison == ComparisonOperator.Gt:
        return values > threshold
    if comparison == ComparisonOperator.Geq:
        return values >= threshold
    raise ValueError("Unknown comparison operator")
