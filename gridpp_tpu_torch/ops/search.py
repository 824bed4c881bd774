"""neighbourhood_search on tensors (gridpp_tpu/ops/search.py; reference
src/api/neighbourhood_search.cpp).

The conditional neighbourhood mean with the reference's scan-order
fallback: the cells of the window whose search value lies in [target_min,
target_max] are averaged; where none does, the value at the window cell
whose search value is closest to the target range is used, but only among
the cells BEFORE the first in-target cell in row-major scan order (the
reference's `else if (counter > 0) continue` short-circuit) and at least
`delta` away from the centre's search value.

The op works on the (Y, X, (2h+1)^2) window stacks of ops/neighbourhood.
_window_stack, which at 2000^2 and h=7 take 3.6 GB each; it runs in bands
of output rows whose working set fits `BAND_BYTES` (each band reads h
halo rows on either side and stacks only its own rows' windows). A cell's
result depends only on its own window, so the bands give the same bits as
one pass.
"""
from __future__ import annotations

import torch

from .neighbourhood import _window_stack

__all__ = ["neighbourhood_search", "band_rows"]

# bytes a (cell, window slot) element takes in the op's working set: two f32
# stacks, the boolean masks and the f32 temporaries of the fallback
_ELEM_BYTES = 48
BAND_BYTES = 1 << 31


def band_rows(shape, halfwidth: int) -> int:
    """Output rows a band takes: its working set within BAND_BYTES, at
    least one row."""
    ny, nx = shape
    h = min(int(halfwidth), max(ny, nx) - 1)
    return max(1, BAND_BYTES // (nx * (2 * h + 1) ** 2 * _ELEM_BYTES))


def _search(array, search_array, h, rows, target_min, target_max, delta):
    """The op on the output rows `rows` of (Y, X) inputs that hold every
    row those rows' windows reach."""
    a_stack = _window_stack(array, h, rows)          # (B, X, W)
    s_stack = _window_stack(search_array, h, rows)   # (B, X, W)
    array, search_array = array[rows], search_array[rows]
    w = a_stack.shape[-1]
    valid = torch.isfinite(s_stack) & torch.isfinite(a_stack)
    in_target = valid & (s_stack >= target_min) & (s_stack <= target_max)
    count = torch.sum(in_target, dim=-1)
    mean = torch.sum(torch.where(in_target, a_stack, 0.0), dim=-1) / \
        torch.clamp(count, min=1)

    # the fallback: nearest to the target among the cells before the first
    # in-target cell (scan order) with |s - s_center| >= delta
    any_target = count > 0
    first_pos = torch.argmax(in_target.to(torch.uint8), dim=-1)
    pos = torch.arange(w, device=array.device)
    before_first = ~any_target[..., None] | (pos < first_pos[..., None])
    center = search_array[..., None]
    eligible = valid & ~in_target & before_first & \
        (torch.abs(s_stack - center) >= delta)
    dist = torch.minimum(torch.abs(s_stack - target_min),
                         torch.abs(s_stack - target_max))
    dist = torch.where(eligible, dist, torch.inf)
    best = torch.argmin(dist, dim=-1)
    has_fallback = torch.any(eligible, dim=-1)
    fallback_val = torch.gather(a_stack, -1, best[..., None])[..., 0]
    return torch.where(any_target, mean,
                       torch.where(has_fallback, fallback_val, array))


def neighbourhood_search(array: torch.Tensor, search_array: torch.Tensor,
                         halfwidth: int, target_min, target_max, delta,
                         apply_array: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """array, search_array: (Y, X) f32 on one device; apply_array: where
    given, only its cells equal to 1 take the result, the others keep
    `array`."""
    ny, nx = array.shape
    h = min(int(halfwidth), max(ny, nx) - 1)
    band = band_rows((ny, nx), h)
    out = torch.empty_like(array)
    for r0 in range(0, ny, band):
        r1 = min(r0 + band, ny)
        lo, hi = max(r0 - h, 0), min(r1 + h, ny)
        out[r0:r1] = _search(array[lo:hi], search_array[lo:hi], h,
                             slice(r0 - lo, r1 - lo), target_min,
                             target_max, delta)
    # an invalid centre search value passes the value through
    out = torch.where(torch.isfinite(search_array), out, array)
    if apply_array is not None:
        out = torch.where(apply_array == 1, out, array)
    return out
