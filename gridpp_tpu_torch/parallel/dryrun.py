"""Spawned multi-rank runs, and the sharded pipeline's dry run
(gridpp_tpu's __graft_entry__.dryrun_multichip).

    from gridpp_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4)                 # four ranks on the cards
    dryrun_multichip(4, device="cpu")   # four gloo ranks on the CPU

`run_ranks(fn, n, ...)` starts n processes with torch.multiprocessing
(spawn), joins them in one process group over localhost and returns each
rank's fn(*args); a rank that fails, or a run that outlasts its timeout,
raises in the caller, and every rank still running is killed.
"""
from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["run_ranks", "dryrun_multichip"]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, backend, fn, args, results):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n))
    # n ranks share the host's cores: torch's CPU ops one thread a rank
    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=n, rank=rank)
        try:
            value = fn(*args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def run_ranks(fn, n: int, *args, backend: str = "gloo",
              timeout: float = 600.0):
    """fn(*args) in n spawned ranks of one process group; returns the
    ranks' return values in rank order. fn must be importable by name
    (spawn pickles it) and its values picklable."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, backend, fn, args, results),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n} ranks ran past {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    raise RuntimeError(f"ranks exited: {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [got[r] for r in range(n)]


def _pipeline_inputs(ny=64, nx=64, n_obs=24, k=8, e=4, seed=0):
    """Tiny synthetic pipeline problem, host precompute included
    (__graft_entry__._pipeline_inputs), as numpy arrays."""
    import gridpp_tpu_torch as gt
    from ..api.oi import _candidates, _resolved_fields

    rng = np.random.default_rng(seed)
    bpoints = _bpoints_for_step(ny, nx)
    po_y = rng.uniform(0, ny * 1000.0, n_obs)
    po_x = rng.uniform(0, nx * 1000.0, n_obs)
    points = gt.Points(po_y, po_x, np.zeros(n_obs), np.zeros(n_obs),
                       gt.Cartesian)
    structure = gt.BarnesStructure(4000.0)
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    cand, mask = _candidates(bpoints, points, loc, k)
    cand = cand.astype(np.int64)
    p1_all = _resolved_fields(bpoints, structure)
    o_fields = _resolved_fields(points, structure)

    background = rng.normal(280, 5, (ny, nx)).astype(np.float32)
    pback = rng.normal(280, 5, n_obs).astype(np.float32)
    pobs = pback + rng.normal(0, 1, n_obs).astype(np.float32)
    ratios = np.full(n_obs, 0.1, np.float32)
    ens = rng.normal(280, 5, (ny * nx, e)).astype(np.float32)
    pens = rng.normal(280, 5, (n_obs, e)).astype(np.float32)
    return dict(
        background=background,
        p1={key: np.asarray(v)[:, None] for key, v in p1_all.items()},
        cand_fields={key: np.asarray(v)[cand] for key, v in o_fields.items()},
        mask=mask, obs=pobs[cand], obs_y=pback[cand], ratios=ratios[cand],
        ens=ens, sig=np.full(n_obs, 0.5, np.float32)[cand],
        yanom=(pens - pens.mean(axis=1, keepdims=True))[cand],
        yhat=pens.mean(axis=1).astype(np.float32)[cand],
        structure=structure)


def _bpoints_for_step(ny, nx):
    import gridpp_tpu_torch as gt
    y = np.repeat(np.arange(ny) * 1000.0, nx)
    x = np.tile(np.arange(nx) * 1000.0, ny)
    return gt.Points(y, x, np.zeros(ny * nx), np.zeros(ny * nx),
                     gt.Cartesian)


def _opoints_for_step(n_obs=24, seed=3):
    import gridpp_tpu_torch as gt
    rng = np.random.default_rng(seed)
    return gt.Points(rng.uniform(0, 64000.0, n_obs),
                     rng.uniform(0, 64000.0, n_obs), np.zeros(n_obs),
                     np.zeros(n_obs), gt.Cartesian)


def _dryrun_rank(n_devices, device):
    """The four steps of __graft_entry__._dryrun_impl on this rank."""
    from ..api.oi import _origin, _resolved_fields
    from ..constants import Statistic
    from ..ops.oi_ensi import ensi_kernel
    from . import distributed as gdist
    from .mesh import make_mesh
    from .sharded import shard_rows, sharded_neighbourhood, sharded_oi_kernel

    mesh = make_mesh(n_devices, device=device)
    a = _pipeline_inputs()
    structure = a["structure"]

    # 1) spatial-parallel stencil with halo exchange
    stencil = sharded_neighbourhood(mesh, 3, int(Statistic.Mean))
    ys, xs = mesh.block_slices(a["background"].shape)
    tile = stencil(gdist.global_field(a["background"][ys, xs], mesh))
    smoothed = gdist.gather_to_host(tile, mesh)

    # 2) data-parallel deterministic OI over gridpoint blocks
    oi = sharded_oi_kernel(mesh, structure, 8, True)
    flat = smoothed.reshape(-1)
    analysis, _ = oi(a["p1"], a["cand_fields"], a["mask"], flat,
                     np.ones_like(flat), a["obs"], a["obs_y"], a["ratios"])
    if not bool(torch.isfinite(analysis).all()):
        raise AssertionError("sharded OI: non-finite analysis")

    # 3) ensemble EnSI update sharded over gridpoints (ensemble axis whole)
    def ensi(*args):
        return ensi_kernel(structure, *args, 8, True)

    out, _cond = shard_rows(mesh, ensi, a["p1"], a["cand_fields"],
                            a["mask"], a["ens"], a["obs"], a["sig"],
                            a["yanom"], a["yhat"])
    if tuple(out.shape) != a["ens"].shape:
        raise AssertionError(f"sharded EnSI: shape {tuple(out.shape)}")

    # 4) the distributed north-star step (halo stencil + replicated-obs OI)
    ny = nx = 64
    bpoints2 = _bpoints_for_step(ny, nx)
    origin = _origin(bpoints2)
    p1f = {k: np.asarray(v, np.float32).reshape(ny, nx)
           for k, v in _resolved_fields(bpoints2, structure,
                                        origin).items()}
    opoints2 = _opoints_for_step()
    of = {k: np.asarray(v, np.float32)
          for k, v in _resolved_fields(opoints2, structure, origin).items()}
    rng = np.random.default_rng(1)
    bg2 = rng.normal(280, 5, (ny, nx)).astype(np.float32)
    n_obs = opoints2.size()
    pbg2 = rng.normal(280, 5, n_obs).astype(np.float32)

    def run(m):
        step = gdist.make_distributed_step(m, structure, halfwidth=3,
                                           statistic=0, max_points=8,
                                           field_keys=tuple(p1f.keys()))
        by, bx = m.block_slices((ny, nx))
        out = step(gdist.global_field(bg2[by, bx], m),
                   {k: gdist.global_field(v[by, bx], m)
                    for k, v in p1f.items()},
                   {k: gdist.replicate(v, m) for k, v in of.items()},
                   gdist.replicate(pbg2 + 1.0, m), gdist.replicate(pbg2, m),
                   gdist.replicate(np.full(n_obs, 0.1, np.float32), m))
        return gdist.gather_to_host(out, m)

    out2 = run(mesh)
    if not np.isfinite(out2).all():
        raise AssertionError("distributed step: non-finite analysis")
    # with >= 4 ranks the mesh splits both axes (corner halos, both-axis
    # rank boundaries): hold it to the same step on a one-rank mesh
    if n_devices >= 4:
        if min(mesh.ranks.shape) < 2:
            raise AssertionError(f"mesh {mesh.ranks.shape} splits one axis")
        out1 = run(make_mesh(1, device=device))
        np.testing.assert_allclose(out2, out1, rtol=2e-5, atol=2e-4)


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900.0):
    """Run one full sharded pipeline step on an n-rank mesh: the sharded
    stencil, the sharded OI, the sharded EnSI update and the distributed
    step, in n spawned ranks. device None: each rank on
    cuda:(rank % cards), NCCL when there are n cards, else gloo through
    host buffers; device="cpu": gloo on the CPU. Raises on any rank's
    failure."""
    n = int(n_devices)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu'")
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        backend = "gloo"
    run_ranks(_dryrun_rank, n, n, device, backend=backend, timeout=timeout)
