"""Rank meshes (gridpp_tpu/parallel/mesh.py).

The natural decomposition for gridded post-processing is spatial: the
(Y, X) grid splits over a 2-D ('y', 'x') grid of ranks; neighbourhood
stencils need halo exchange between neighbouring ranks (halo.py), while
per-gridpoint OI solves are embarrassingly parallel (sharded.py).

One process per rank and one device per rank: a `Mesh` is a (py, px) grid
of the ranks of a torch.distributed process group, with this rank's
coordinates and device. Where gridpp_tpu's mesh lists jax devices, this
one lists ranks; the transport is the group's (NCCL between cards, gloo
between CPU ranks, or between card ranks through host buffers, halo.py).
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "rank_device"]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given (the tests pass "cpu"),
    else cuda:(LOCAL_RANK % device_count), LOCAL_RANK defaulting to the
    rank. Raises when no card is present and no device was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run the "
                           "ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", _rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """A (py, px) grid of global ranks.

    ranks: (py, px) int array; axis_names: ('y', 'x'); shape: {'y': py,
    'x': px}, as jax's Mesh.shape; device: this rank's device; group: the
    process group the ranks belong to (None for a one-rank mesh, which
    exchanges nothing); coords: this rank's (row, column), None when it is
    not in the mesh."""

    def __init__(self, ranks, axis_names, device, group=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 2:
            raise ValueError("a mesh is a 2-D grid of ranks")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.device = torch.device(device)
        self.group = group if self.ranks.size > 1 else None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        where = np.argwhere(self.ranks == _rank())
        self.coords = tuple(int(v) for v in where[0]) if len(where) else None

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def index(self) -> int:
        """This rank's position in the mesh, row-major: its rank in the
        group for meshes over the group's ranks in order."""
        return self.coords[0] * self.ranks.shape[1] + self.coords[1]

    def neighbour(self, axis: int, step: int):
        """Global rank `step` places along axis (0: y, 1: x), or None past
        the mesh's edge."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.ranks.shape[axis]:
            return None
        return int(self.ranks[c[0], c[1]])

    def staged(self) -> bool:
        """Whether tensors cross the group through host buffers: gloo is a
        CPU transport, so a rank whose tiles live on a card copies its
        strips down and up around each exchange."""
        return (self.group is not None and self.device.type != "cpu"
                and dist.get_backend(self.group) == "gloo")

    def block_slices(self, global_shape):
        """(y_slice, x_slice) of this rank's block of a (Y, X) field."""
        py, px = self.ranks.shape
        gy, gx = global_shape
        if gy % py or gx % px:
            raise ValueError(f"global shape {tuple(global_shape)} must "
                             f"divide the mesh {(py, px)}")
        by, bx = gy // py, gx // px
        r, c = self.coords
        return slice(r * by, (r + 1) * by), slice(c * bx, (c + 1) * bx)


def make_mesh(n_devices: int | None = None, axis_names=("y", "x"),
              device=None) -> Mesh:
    """2-D mesh over the first n ranks (all ranks of the default group by
    default), as square as the count allows. n_devices=1 gives each rank
    a one-rank mesh of its own. Every rank of the group calls it."""
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    ny = int(math.sqrt(n))
    while n % ny != 0:
        ny -= 1
    nx = n // ny
    if n == 1:
        return Mesh([[_rank()]], axis_names, rank_device(device))
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(np.arange(n).reshape(ny, nx), axis_names,
                rank_device(device), group)
