"""Rank programs of tests/test_torch_parallel.py.

Spawned ranks import this module by name (torch.multiprocessing pickles a
function by its import path), so it imports torch, numpy and
gridpp_tpu_torch only: no jax, and nothing of the test module. Every rank
runs the same program; rank 0 returns the gathered results.
"""
import os

import numpy as np
import torch

import gridpp_tpu_torch as gt
from gridpp_tpu_torch.api.oi import (_candidates, _origin,
                                     _resolved_fields)
from gridpp_tpu_torch.parallel import (make_mesh, sharded_neighbourhood,
                                       sharded_oi_kernel)
from gridpp_tpu_torch.parallel import distributed as gdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = (int(gt.Mean), int(gt.Min), int(gt.Max), int(gt.Count))
HALFWIDTHS = (0, 1, 3, 7)


def stencil_field(ny, nx, seed=42, nan_frac=0.15):
    """tests/test_parallel.py's field."""
    rng = np.random.default_rng(seed)
    x = rng.random((ny, nx)).astype(np.float32)
    x[rng.random((ny, nx)) < nan_frac] = np.nan
    return x


def oi_problem():
    """tests/test_parallel.py::TestShardedOI's problem, with the port's
    host helpers; returns the kernel's arguments as numpy."""
    rng = np.random.default_rng(1)
    n = 64
    y = np.arange(n) * 500.0
    bpoints = gt.Points(y, np.zeros(n), np.zeros(n), np.zeros(n),
                        gt.Cartesian)
    p = 10
    py = rng.uniform(0, n * 500.0, p)
    points = gt.Points(py, np.zeros(p), np.zeros(p), np.zeros(p),
                       gt.Cartesian)
    structure = gt.BarnesStructure(2000)
    background = rng.normal(0, 1, n).astype(np.float32)
    pback = rng.normal(0, 1, p).astype(np.float32)
    pobs = pback + rng.normal(0, 0.5, p).astype(np.float32)
    ratios = np.full(p, 0.1, np.float32)
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    cand, mask = _candidates(bpoints, points, loc, 5)
    cand = cand.astype(np.int64)
    p1 = {k: np.asarray(v)[:, None]
          for k, v in _resolved_fields(bpoints, structure).items()}
    o_fields = _resolved_fields(points, structure)
    return structure, (p1, {k: np.asarray(v)[cand]
                            for k, v in o_fields.items()},
                       mask, background, np.ones(n, np.float32),
                       pobs[cand], pback[cand], ratios[cand])


def step_problem(n=64, n_obs=200, seed=0):
    """tests/test_distributed.py's problem: (structure, background, p1
    fields (Y, X), obs fields, pobs, pback, ratios), numpy."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 62, n),
                             np.linspace(5, 12, n), indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 62, n_obs), rng.uniform(5, 12, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    structure = gt.BarnesStructure(100000.0)
    pback = gt.nearest(grid, pts, background)
    pobs = (pback + rng.normal(0, 1, n_obs)).astype(np.float32)
    ratios = np.full(n_obs, 0.1, np.float32)
    bpoints = grid.to_points()
    origin = _origin(bpoints)
    p1 = {k: np.asarray(v, np.float32).reshape(n, n)
          for k, v in _resolved_fields(bpoints, structure, origin).items()}
    obs_f = {k: np.asarray(v, np.float32)
             for k, v in _resolved_fields(pts, structure, origin).items()}
    return structure, background, p1, obs_f, pobs, pback, ratios


def distributed_step(mesh, block_slices):
    """The distributed step on the mesh, each rank on its block
    (block_slices(global_shape)); returns the gathered analysis."""
    structure, background, p1, obs_f, pobs, pback, ratios = step_problem()
    step = gdist.make_distributed_step(mesh, structure, halfwidth=3,
                                       statistic=int(gt.Mean),
                                       max_points=8,
                                       field_keys=tuple(p1.keys()))
    ys, xs = block_slices(background.shape)
    out = step(gdist.global_field(background[ys, xs], mesh),
               {k: gdist.global_field(v[ys, xs], mesh)
                for k, v in p1.items()},
               {k: gdist.replicate(v, mesh) for k, v in obs_f.items()},
               gdist.replicate(pobs, mesh), gdist.replicate(pback, mesh),
               gdist.replicate(ratios, mesh))
    return gdist.gather_to_host(out, mesh)


def _tile_run(mesh, x, h, stat):
    ys, xs = mesh.block_slices(x.shape)
    fn = sharded_neighbourhood(mesh, h, stat)
    return gdist.gather_to_host(fn(gdist.global_field(x[ys, xs], mesh)),
                                mesh)


def eight_ranks():
    """tests/test_parallel.py and test_distributed.py's cases on make_mesh(8)
    (2 x 4), plus the one-rank mesh of each rank."""
    mesh = make_mesh(8, device="cpu")
    ny, nx = mesh.shape["y"] * 16, mesh.shape["x"] * 16
    x = stencil_field(ny, nx)
    out = {"mesh": mesh.ranks.shape,
           "stencil": {(h, s): _tile_run(mesh, x, h, s)
                       for h in HALFWIDTHS for s in STATS}}
    rng = np.random.default_rng(0)
    xl = rng.random((mesh.shape["y"] * 8, mesh.shape["x"] * 8)).astype(
        np.float32)
    out["large_halo"] = _tile_run(mesh, xl, 4, int(gt.Mean))
    try:
        _tile_run(mesh, xl, 9, int(gt.Mean))
        out["deep_halo"] = None
    except ValueError as e:
        out["deep_halo"] = str(e)
    structure, args = oi_problem()
    kern = sharded_oi_kernel(mesh, structure, 5, True)
    out["oi"] = tuple(t.numpy() for t in kern(*args))
    out["step"] = distributed_step(mesh, mesh.block_slices)
    one = make_mesh(1, device="cpu")
    out["step_one_rank"] = distributed_step(one, one.block_slices)
    return out if torch.distributed.get_rank() == 0 else None


def host_grid(host_shape, device="cpu"):
    """The distributed step on global_mesh(host_shape=...), each process
    on its local_block_slices; returns (mesh shape, this rank's slices,
    initialize() now, is_distributed(), the gathered analysis, K1's
    launches in the step) from every rank. device None: the rank's card."""
    from gridpp_tpu_torch.ops import stencil
    mesh = gdist.global_mesh(host_shape=host_shape, device=device)
    slices = gdist.local_block_slices((64, 64), host_shape)
    stencil.neighbourhood_mean_cuda.launches = 0
    out = distributed_step(
        mesh, lambda shape: gdist.local_block_slices(shape, host_shape))
    return (mesh.ranks.shape, (slices[0].start, slices[0].stop,
                               slices[1].start, slices[1].stop),
            gdist.initialize(), gdist.is_distributed(), out,
            stencil.neighbourhood_mean_cuda.launches)
