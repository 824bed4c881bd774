"""The neighbourhood mean (reference neighbourhood.cpp, Statistic Mean).

Each cell's mean over the (2h + 1) x (2h + 1) window around it, clipped at
the grid's edge; non-finite cells are left out of the sum and the count,
and a window with no finite cell gives NaN. Summed in float64 through
two-dimensional running sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_sums(x, h: int):
    """Sum of x (Y, X) over each clipped (2h + 1)^2 window, by prefix
    sums padded with one leading zero row and column."""
    ny, nx = x.shape
    c = F.pad(torch.cumsum(torch.cumsum(x, 0), 1), (1, 0, 1, 0))
    r0 = torch.clamp(torch.arange(ny, device=x.device) - h, min=0)
    r1 = torch.clamp(torch.arange(ny, device=x.device) + h + 1, max=ny)
    c0 = torch.clamp(torch.arange(nx, device=x.device) - h, min=0)
    c1 = torch.clamp(torch.arange(nx, device=x.device) + h + 1, max=nx)
    return (c[r1][:, c1] - c[r0][:, c1] - c[r1][:, c0] + c[r0][:, c0])


def mean(field, h: int):
    """float64 neighbourhood mean of field (Y, X), any float type."""
    x = field.to(torch.float64)
    if h <= 0:
        return x
    fin = torch.isfinite(x)
    s = _window_sums(torch.where(fin, x, 0.0), h)
    n = _window_sums(fin.to(torch.float64), h)
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.nan)
