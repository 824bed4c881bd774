"""Neighbourhood (moving-window) statistics on tensors.

The counterpart of gridpp_tpu/ops/neighbourhood.py's `neighbourhood` for
Mean, Sum and Count, with the semantics of its `_xla_basic` path: NaN (and
any non-finite value) is missing, windows are clipped at the domain edge,
and a halfwidth beyond the grid is clipped per axis. A CUDA tensor goes
through kernel K1 (ops/stencil.py), a CPU tensor through K1's plain twin.
"""
from __future__ import annotations

import torch

from ..constants import Statistic
from . import stencil

__all__ = ["neighbourhood"]


def neighbourhood(input: torch.Tensor, halfwidth: int,
                  statistic: int) -> torch.Tensor:
    """Moving-window statistic over the last two axes (Y, X) of a (Y, X)
    or (B, Y, X) f32 tensor (neighbourhood.cpp:28-241)."""
    statistic = int(statistic)
    h = int(halfwidth)
    if statistic not in stencil.STATS:
        raise NotImplementedError(
            f"statistic {Statistic(statistic).name} is not ported yet "
            "(ROADMAP.md, open item 9: the rest of the neighbourhood family)")
    if h < 0:
        raise ValueError("halfwidth must be >= 0")
    x = input.to(torch.float32)
    if h == 0:
        valid = torch.isfinite(x)
        if statistic == int(Statistic.Count):
            return valid.to(torch.float32)
        return torch.where(valid, x, torch.nan)
    hy = min(h, x.shape[-2] - 1)
    hx = min(h, x.shape[-1] - 1)
    if x.is_cuda:
        return stencil.neighbourhood_mean_cuda(x.contiguous(), hy, hx,
                                               statistic)
    if x.device.type != "cpu":
        raise ValueError(f"no neighbourhood kernel for device {x.device}")
    return stencil.neighbourhood_mean_plain(x, hy, hx, statistic)
