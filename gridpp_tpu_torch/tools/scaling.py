"""Scaling of gridpp_tpu_torch's parallel layer on simulated hosts.

Simulates an N-host job on one machine: N gloo ranks on the CPU, rank i
pinned to core i mod ncpu (of the cores this process may use) with one
torch thread, each rank its block of the grid. Times the distributed
north-star step (`parallel.distributed.make_distributed_step`: halo
exchange, neighbourhood Mean h=7, the dense OI of every obs, max_points
10) on one rank and on N ranks, and checks the gathered analysis against
the one-rank result; bit for bit is expected, and any difference is
printed.

    python -m gridpp_tpu_torch.tools.scaling [--hosts 2] [--n 512]
        [--obs 2000] [--host-grid HYxHX] [--weak] [--out PATH]

Strong scaling: the same n x n grid on 1 and N ranks. --weak: n x n on one
rank against (N n) x n on N ranks, the parity then checked against one
rank on the (N n) x n grid. Efficiency = throughput_N / (N throughput_1),
throughput in gridpoints/s. Ranks run with device="cpu" and no card
visible (CUDA_VISIBLE_DEVICES=""), so that none starts a CUDA context.
Writes the JSON report to --out (default build/scaling.json under the
checkout) and prints it as the last line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
H = 7
MAX_POINTS = 10
ITERS = 3


def cores() -> list:
    """The cores this process may run on, in order."""
    return sorted(os.sched_getaffinity(0))


def problem(n_rows, n, n_obs):
    """The step's problem on an n_rows x n grid over 55-62N, 5-12E (seed
    0, BarnesStructure(50 km), ratios 0.1): (structure, background,
    grid-point fields (Y, X), obs fields, pobs, pback, ratios), numpy."""
    import gridpp_tpu_torch as gt
    from ..api.oi import _origin, _resolved_fields

    rng = np.random.default_rng(0)
    lats, lons = np.meshgrid(np.linspace(55, 62, n_rows),
                             np.linspace(5, 12, n), indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 62, n_obs), rng.uniform(5, 12, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    background = rng.normal(280, 5, (n_rows, n)).astype(np.float32)
    structure = gt.BarnesStructure(50000.0)
    pback = background.reshape(-1)[grid.nearest_map(pts.lats, pts.lons)]
    pobs = (pback + rng.normal(0, 1, n_obs)).astype(np.float32)
    bpoints = grid.to_points()
    origin = _origin(bpoints)
    p1 = {k: np.asarray(v, np.float32).reshape(n_rows, n)
          for k, v in _resolved_fields(bpoints, structure, origin).items()}
    obs = {k: np.asarray(v, np.float32)
           for k, v in _resolved_fields(pts, structure, origin).items()}
    return (structure, background, p1, obs, pobs, pback,
            np.full(n_obs, 0.1, np.float32))


def rank_step(n_rows, n, n_obs, host_shape, iters, warm):
    """One simulated host (run in a spawned rank): pin this rank to its
    core, run the step on its block (once untimed first when warm), time
    `iters` steps; rank 0 returns the seconds a step and the gathered
    analysis."""
    import torch
    import torch.distributed as dist

    from ..constants import Statistic
    from ..parallel import distributed as gdist

    rank = dist.get_rank()
    allowed = cores()
    core = allowed[rank % len(allowed)]
    os.sched_setaffinity(0, {core})
    torch.set_num_threads(1)
    mesh = gdist.global_mesh(host_shape=host_shape, device="cpu")
    structure, background, p1, obs, pobs, pback, ratios = problem(
        n_rows, n, n_obs)
    ys, xs = gdist.local_block_slices(background.shape, host_shape)
    bg = gdist.global_field(background[ys, xs], mesh)
    tiles = {k: gdist.global_field(v[ys, xs], mesh) for k, v in p1.items()}
    rest = ({k: gdist.replicate(v, mesh) for k, v in obs.items()},
            gdist.replicate(pobs, mesh), gdist.replicate(pback, mesh),
            gdist.replicate(ratios, mesh))
    step = gdist.make_distributed_step(mesh, structure, H,
                                       int(Statistic.Mean), MAX_POINTS,
                                       field_keys=tuple(p1))
    if warm:
        step(bg, tiles, *rest)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(bg, tiles, *rest)
    dist.barrier()
    secs = (time.perf_counter() - t0) / iters
    analysis = gdist.gather_to_host(out, mesh)
    return {"rank": rank, "core": core, "time_s": secs,
            "device": str(mesh.device), "backend": dist.get_backend(),
            "analysis": analysis if rank == 0 else None}


@contextlib.contextmanager
def _no_card():
    """Spawned ranks see no card: set CUDA_VISIBLE_DEVICES="" for them."""
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        yield
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def launch(hosts, n_rows, n, n_obs, host_shape=None, iters=ITERS,
           warm=True, timeout=600.0):
    """The step on `hosts` gloo CPU ranks; returns every rank's result."""
    from ..parallel.dryrun import run_ranks
    with _no_card():
        return run_ranks(rank_step, hosts, n_rows, n, n_obs, host_shape,
                         iters, warm, backend="gloo", timeout=timeout)


def measure(hosts=2, n=512, n_obs=2000, host_grid="", weak=False,
            iters=ITERS, warm=True, timeout=600.0, log=print):
    """The report (a dict) of one strong or weak scaling run. warm=False
    times the first step too: the CPU step compiles nothing, and a caller
    with a time limit saves a step a launch."""
    host_shape = (tuple(int(v) for v in host_grid.split("x"))
                  if host_grid else None)
    n_rows = n * hosts if weak else n
    log(f"ncpu={len(cores())} (cores {cores()}), {hosts} hosts, "
        f"{'weak' if weak else 'strong'} scaling, grid {n_rows}x{n} on "
        f"{hosts}, {n}x{n} on one rank, {n_obs} obs", flush=True)
    t0 = time.perf_counter()
    single = launch(1, n, n, n_obs, None, iters, warm, timeout)[0]
    multi = launch(hosts, n_rows, n, n_obs, host_shape, iters, warm,
                   timeout)
    ref = single if not weak else launch(1, n_rows, n, n_obs, None, iters,
                                         warm, timeout)[0]
    got, want = multi[0]["analysis"], ref["analysis"]
    bit_parity = bool(np.array_equal(got, want, equal_nan=True))
    diff = float(np.nanmax(np.abs(got.astype(np.float64) - want)))
    t1 = single["time_s"]
    tn = max(r["time_s"] for r in multi)
    tput_1 = n * n / t1
    tput_n = n_rows * n / tn
    report = {
        "metric": ("parallel_weak_scaling_efficiency" if weak
                   else "parallel_strong_scaling_efficiency"),
        "mode": "weak" if weak else "strong",
        "grid": f"{n_rows}x{n}", "grid_1host": f"{n}x{n}", "obs": n_obs,
        "hosts": hosts, "iters": iters, "warm": warm,
        "host_grid": host_grid or f"{hosts}x1",
        "ncpu": len(cores()), "cores": [r["core"] for r in multi],
        "device": multi[0]["device"], "backend": multi[0]["backend"],
        "t_1host_s": t1, f"t_{hosts}host_s": tn,
        "t_ranks_s": [r["time_s"] for r in multi],
        "gridpoints_per_s_1host": tput_1,
        f"gridpoints_per_s_{hosts}host": tput_n,
        "speedup": tput_n / tput_1,
        "efficiency": tput_n / (hosts * tput_1),
        "bit_parity": bit_parity, "max_abs_diff": diff,
        "shape": list(got.shape), "wall_s": time.perf_counter() - t0,
    }
    log(f"  {iters} timed step(s){' after a warm one' if warm else ''}: "
        f"one rank {t1:.4f} s a step, {hosts} ranks "
        f"{', '.join(f'{r['time_s']:.4f}' for r in multi)} s; efficiency "
        f"{report['efficiency']:.3f}; gathered analysis "
        f"{'bit for bit' if bit_parity else 'NOT bit for bit'} with one "
        f"rank's (max|d| {diff:.3g})", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--obs", type=int, default=2000)
    ap.add_argument("--host-grid", default="", dest="host_grid",
                    help="2-D host layout HYxHX (e.g. 2x2); default "
                         "splits only the y axis between hosts")
    ap.add_argument("--weak", action="store_true",
                    help="grow the grid's rows with the host count")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a launch's ranks may take")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "scaling.json"))
    args = ap.parse_args(argv)
    report = measure(args.hosts, args.n, args.obs, args.host_grid,
                     args.weak, args.iters, args.timeout)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if report["bit_parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
