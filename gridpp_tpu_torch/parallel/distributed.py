"""Multi-process distributed execution (gridpp_tpu/parallel/distributed.py).

The reference is single-process (OpenMP only, gridpp.cpp:45-68); this is
the layer for a grid spread over many cards, one process per rank and one
card per rank:

- `initialize`:   torch.distributed bring-up, driven by arguments, the
                  GRIDPP_* environment variables or torchrun's. No-op for
                  single-process runs.
- `global_mesh`:  a ('y', 'x') mesh over every rank of the job, laid out as
                  a grid of processes.
- `global_field`: this rank's block of a field, on its device. torch has
                  no global array: a field spread over the mesh is each
                  rank's block, and `gather_to_host` assembles it.
- `make_distributed_step`: the north-star pipeline (neighbourhood smooth +
                  deterministic OI) on each rank's block: halo exchange for
                  the stencil, replicated obs for the local OI solves.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import neighbourhood as nops
from ..ops.oi import oi_dense_sweep
from .halo import halo_exchange_2d
from .mesh import Mesh, _rank, _world, make_mesh, rank_device

__all__ = [
    "initialize", "is_distributed", "global_mesh", "global_field",
    "replicate", "make_distributed_step", "gather_to_host",
    "local_block_slices",
]


def _first(*values):
    return next((v for v in values if v is not None), None)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up torch.distributed for a multi-process job: NCCL when a
    card is present, else gloo.

    Each value comes from its argument, else GRIDPP_COORDINATOR
    (host:port) / GRIDPP_NUM_PROCESSES / GRIDPP_PROCESS_ID, else torchrun's
    MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK. Returns True when a
    multi-process group is up; safe to call twice and in single-process
    runs (False).
    """
    env = os.environ
    torchrun = (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
                if "MASTER_ADDR" in env else None)

    def env_int(*names):
        return _first(*(int(env[n]) if n in env else None for n in names))

    coordinator_address = _first(coordinator_address,
                                 env.get("GRIDPP_COORDINATOR"), torchrun)
    num_processes = _first(num_processes,
                           env_int("GRIDPP_NUM_PROCESSES", "WORLD_SIZE"))
    process_id = _first(process_id, env_int("GRIDPP_PROCESS_ID", "RANK"))
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("a distributed run needs the coordinator address, "
                         "the number of processes and this process's id")
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        # this process's card, as rank_device will read it once the group
        # is up (LOCAL_RANK, else the rank)
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


def is_distributed() -> bool:
    return _world() > 1


def global_mesh(axis_names=("y", "x"), host_shape=None, device=None) -> Mesh:
    """('y', 'x') mesh over all ranks of the job.

    host_shape=(hy, hx) lays the processes out as a 2-D grid in
    process-major order: process p sits at row p // hx, column p % hx. The
    default (n, 1) splits only 'y'. One process (no group, or a group of
    one) gives a 1 x 1 mesh. device: as `mesh.rank_device`."""
    n = _world()
    if n > 1:
        hy, hx = (n, 1) if host_shape is None else (int(host_shape[0]),
                                                    int(host_shape[1]))
        if hy * hx != n:
            raise ValueError(f"host_shape {host_shape} does not cover {n} "
                             "hosts")
        return Mesh(np.arange(n).reshape(hy, hx), axis_names,
                    rank_device(device), dist.group.WORLD)
    return make_mesh(axis_names=axis_names, device=device)


def local_block_slices(global_shape, host_shape=None):
    """(y_slice, x_slice) of this process's contiguous block of a (Y, X)
    field laid out on a global_mesh(host_shape=...) mesh."""
    n = _world()
    hy, hx = (n, 1) if host_shape is None else (int(host_shape[0]),
                                                int(host_shape[1]))
    gy, gx = global_shape
    if gy % hy or gx % hx:
        raise ValueError(
            f"global shape {global_shape} must divide host grid {(hy, hx)}")
    r, c = divmod(_rank(), hx)
    by, bx = gy // hy, gx // hx
    return slice(r * by, (r + 1) * by), slice(c * bx, (c + 1) * bx)


def global_field(local_block, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a field, as a tensor on its device.

    torch has no global array: a field spread over the mesh is the blocks
    its ranks hold (`local_block_slices` / `Mesh.block_slices` say which),
    and `gather_to_host` assembles it."""
    return torch.as_tensor(local_block, device=mesh.device)


def replicate(value, mesh: Mesh) -> torch.Tensor:
    """A (small) array on this rank's device - the observation vectors'
    layout. All processes must pass identical values."""
    return torch.as_tensor(value, device=mesh.device)


def gather_to_host(block: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The (Y, X) field whose blocks the mesh's ranks hold, as numpy on
    every rank. Blocks are padded to the largest for the all-gather."""
    if mesh.group is None:
        return block.detach().cpu().numpy()
    dev = torch.device("cpu") if mesh.staged() else block.device
    shape = torch.tensor(block.shape[-2:], device=dev)
    shapes = [torch.empty_like(shape) for _ in range(mesh.size)]
    dist.all_gather(shapes, shape, group=mesh.group)
    shapes = [tuple(int(v) for v in s) for s in shapes]
    my, mx = max(s[0] for s in shapes), max(s[1] for s in shapes)
    wire = torch.full(block.shape[:-2] + (my, mx), torch.nan,
                      dtype=block.dtype, device=dev)
    wire[..., :block.shape[-2], :block.shape[-1]] = block
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    py, px = mesh.ranks.shape
    rows = []
    for r in range(py):
        row = []
        for c in range(px):
            i = r * px + c
            row.append(parts[i][..., :shapes[i][0], :shapes[i][1]].cpu())
        rows.append(torch.cat(row, dim=-1))
    return torch.cat(rows, dim=-2).numpy()


def make_distributed_step(mesh: Mesh, structure, halfwidth: int,
                          statistic: int, max_points: int,
                          allow_extrapolation: bool = True,
                          field_keys=("x", "y", "z", "elev", "laf"),
                          block: int = 4096):
    """North-star pipeline on this rank's block of the mesh.

    Returns step(background (Ty, Tx), p1_fields dict of (Ty, Tx),
    obs_fields dict of (P,), pobs/pbackground/ratios (P,)) -> analysis
    (Ty, Tx), each rank on its own block (`global_field`) with the
    observations replicated (`replicate`).

    Neighbourhood: halo exchange + the local stencil (K1/K2/K3 on a
    card). OI: each rank solves its own gridpoints against every
    observation (ops/oi.oi_dense_sweep, `block` gridpoints a slab, so the
    (block, P) rho panel stays bounded), with no collectives.
    """
    h = int(halfwidth)
    statistic = int(statistic)
    block = int(block)

    def step(bg_tile, p1_tiles, obs_fields, pobs, pbg, ratios):
        padded = halo_exchange_2d(bg_tile, h, mesh)
        sm = nops.neighbourhood(padded, h, statistic)
        if h > 0:
            sm = sm[h:-h, h:-h]
        ty, tx = sm.shape
        flat = sm.reshape(-1)
        out, _ = oi_dense_sweep(
            structure, {k: p1_tiles[k].reshape(-1) for k in field_keys},
            obs_fields, flat, torch.ones_like(flat), pobs, pbg, ratios,
            int(max_points), bool(allow_extrapolation), block)
        return out.reshape(ty, tx)

    return step
