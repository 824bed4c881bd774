"""Sharded pipeline ops: multi-rank neighbourhood stencils and OI
(gridpp_tpu/parallel/sharded.py).

- `sharded_neighbourhood`: a (Y, X) field split over a ('y', 'x') mesh of
  ranks; halo exchange (halo.py) + the local stencil (ops/neighbourhood.py:
  K1/K2/K3 on a card, their plain versions on the CPU). NaN halos at the
  domain boundary reproduce the reference's clipped windows, so results
  match the single-device path.
- `sharded_oi_kernel`: the per-gridpoint OI solves are independent, so
  each rank solves a contiguous share of the gridpoints (pure data
  parallelism) and the shares are all-gathered.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import neighbourhood as nops
from ..ops.oi import oi_block
from .halo import halo_exchange_2d
from .mesh import Mesh

__all__ = ["sharded_neighbourhood", "sharded_oi_kernel"]


def sharded_neighbourhood(mesh: Mesh, halfwidth: int, statistic: int):
    """A (Ty, Tx) -> (Ty, Tx) stencil of this rank's tile of a field laid
    out on the mesh (`Mesh.block_slices`); every rank of the mesh calls
    it on its own tile."""
    h = int(halfwidth)
    statistic = int(statistic)

    def tile_fn(tile: torch.Tensor) -> torch.Tensor:
        padded = halo_exchange_2d(tile, h, mesh)
        out = nops.neighbourhood(padded, h, statistic)
        if h == 0:
            return out
        return out[..., h:-h, h:-h]

    return tile_fn


def _all_gather_rows(mesh: Mesh, share: torch.Tensor) -> torch.Tensor:
    """The mesh's equal-sized shares concatenated along dim 0 in mesh
    order, on every rank (through host buffers on a gloo group)."""
    if mesh.group is None:
        return share
    wire = share.contiguous()
    if mesh.staged():
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).to(share.device)


def _take_rows(a, rows, device):
    if isinstance(a, dict):
        return {k: _take_rows(v, rows, device) for k, v in a.items()}
    return torch.as_tensor(a, device=device)[rows]


def shard_rows(mesh: Mesh, fn, *args):
    """fn over this rank's contiguous share of the leading (B) axis of
    every array in args (dicts of arrays too), the shares all-gathered:
    every rank returns fn's outputs over all B rows. B is padded to a
    multiple of the ranks with copies of its last row, cropped after."""
    first = args[0]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    b = first.shape[0]
    share = -(-b // mesh.size)
    rows = torch.arange(mesh.index * share, (mesh.index + 1) * share,
                        device=mesh.device).clamp_(max=b - 1)
    outs = fn(*(_take_rows(a, rows, mesh.device) for a in args))
    return tuple(_all_gather_rows(mesh, o)[:b] for o in outs)


def sharded_oi_kernel(mesh: Mesh, structure, max_points: int,
                      allow_extrapolation: bool):
    """OI block solver (ops/oi.oi_block) sharded over the gridpoint axis.

    Inputs shaped (B, ...), the same on every rank (numpy arrays or
    tensors); observation-side fields inside cand_fields are already
    gathered per gridpoint. Returns (analysis (B,), analysis variance
    (B,)) on this rank's device, whole on every rank."""

    def kernel(p1_fields, cand_fields, cand_valid, background, bvariance,
               obs, obs_y, ratios):
        return oi_block(structure, p1_fields, cand_fields, cand_valid,
                        background, bvariance, obs, obs_y, ratios,
                        int(max_points), bool(allow_extrapolation))

    def wrapper(p1_fields, cand_fields, cand_valid, background, bvariance,
                obs, obs_y, ratios):
        return shard_rows(mesh, kernel, p1_fields, cand_fields, cand_valid,
                          background, bvariance, obs, obs_y, ratios)

    return wrapper
