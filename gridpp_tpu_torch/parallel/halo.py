"""Halo exchange for spatially sharded fields (gridpp_tpu/parallel/halo.py).

Each rank holds a (Y/py, X/px) tile. Stencil ops of halfwidth h need the
h-deep strips of the 4 (8 with corners) neighbouring ranks. Strips move by
point-to-point sends (`dist.batch_isend_irecv`, every send and receive of
a pass posted at once, so neither NCCL nor gloo can deadlock); ranks at the
domain boundary receive a NaN halo, which the NaN-skipping stencils treat
exactly like the reference's clipped-at-the-edge windows, so the sharded
result has the single-device structure.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["halo_exchange_2d"]


def _shift(mesh: Mesh, axis: int, to_next, to_prev):
    """Send to_next to the next rank along axis and to_prev to the
    previous one; returns (from_prev, from_next), NaN where there is no
    sender (gridpp_tpu's `_shift` both ways)."""
    prev, nxt = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
    staged = mesh.staged()

    def wire(t):
        t = t.contiguous()
        return t.cpu() if staged else t

    ops, got = [], {}
    # tags: a message to the next rank is 2 axis + 1, to the previous one
    # 2 axis (gloo matches them; NCCL orders them by the pair)
    for peer, send, tag_out, tag_in in ((prev, to_prev, 2 * axis,
                                         2 * axis + 1),
                                        (nxt, to_next, 2 * axis + 1,
                                         2 * axis)):
        if peer is None:
            continue
        buf = wire(send)
        got[peer] = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer, mesh.group, tag_out))
        ops.append(dist.P2POp(dist.irecv, got[peer], peer, mesh.group,
                              tag_in))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def land(peer, like):
        if peer is None:
            return torch.full_like(like, torch.nan)
        return got[peer].to(like.device)

    return land(prev, to_next), land(nxt, to_prev)


def halo_exchange_2d(tile: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (..., Ty, Tx) tile with h-deep halos from the neighbouring
    ranks; returns (..., Ty+2h, Tx+2h). Corners come for free: the y pass
    runs first and the x pass's strips include its halos. Every rank of the
    mesh calls it. A halo deeper than the tile raises: ranks exchange with
    their immediate neighbours only, as jax's ppermute does."""
    h = int(h)
    if h == 0:
        return tile
    ty, tx = tile.shape[-2:]
    if h > ty or h > tx:
        raise ValueError(f"halo {h} is deeper than the tile {ty} x {tx}: "
                         "ranks exchange with their immediate neighbours "
                         "only")
    from_above, from_below = _shift(mesh, 0, tile[..., ty - h:, :],
                                    tile[..., :h, :])
    tile_y = torch.cat([from_above, tile, from_below], dim=-2)
    from_left, from_right = _shift(mesh, 1, tile_y[..., :, tx - h:],
                                   tile_y[..., :, :h])
    return torch.cat([from_left, tile_y, from_right], dim=-1)
