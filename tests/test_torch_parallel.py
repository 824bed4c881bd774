"""gridpp_tpu_torch.parallel on torch.distributed against gridpp_tpu.parallel.

The port's ranks are processes: a module fixture spawns them once (gloo on
the CPU, `parallel.dryrun.run_ranks`) and runs every case of
tests/_torch_parallel_ranks.py in them: 8 ranks on make_mesh(8) (2 x 4),
2 "hosts" on global_mesh(), and a 2 x 2 host grid. Each spawned run has
its own timeout, past which its ranks are killed. gridpp_tpu runs the same
cases on conftest's 8 CPU devices in this process (tests/test_parallel.py,
tests/test_distributed.py), and the results are compared at those files'
bars.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_parallel_ranks as ranks  # noqa: E402

import gridpp_tpu as gj  # noqa: E402
from gridpp_tpu.api.oi import _candidates, _resolved_fields  # noqa: E402
from gridpp_tpu.constants import Statistic  # noqa: E402
from gridpp_tpu.ops import neighbourhood as jnops  # noqa: E402
from gridpp_tpu.parallel import (  # noqa: E402
    make_mesh, sharded_neighbourhood, sharded_oi_kernel)
from gridpp_tpu.parallel import distributed as jdist  # noqa: E402

from gridpp_tpu_torch.parallel import distributed as tdist  # noqa: E402
from gridpp_tpu_torch.parallel.dryrun import (dryrun_multichip,  # noqa: E402
                                              run_ranks)

# seconds a spawned run may take before its ranks are killed
TIMEOUT = 180


@pytest.fixture(scope="module")
def port():
    """Every rank program, the three runs at once."""
    with ThreadPoolExecutor(3) as pool:
        eight = pool.submit(run_ranks, ranks.eight_ranks, 8,
                            timeout=TIMEOUT)
        two = pool.submit(run_ranks, ranks.host_grid, 2, None,
                          timeout=TIMEOUT)
        four = pool.submit(run_ranks, ranks.host_grid, 4, (2, 2),
                           timeout=TIMEOUT)
        return {"eight": eight.result()[0], "two": two.result(),
                "four": four.result()}


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def test_mesh_is_gridpp_tpus(port, jmesh):
    assert port["eight"]["mesh"] == jmesh.devices.shape == (2, 4)


@pytest.mark.parametrize("h", ranks.HALFWIDTHS)
@pytest.mark.parametrize("stat", ranks.STATS)
def test_sharded_neighbourhood_matches_gridpp_tpu(port, jmesh, h, stat):
    x = ranks.stencil_field(jmesh.shape["y"] * 16, jmesh.shape["x"] * 16)
    want = np.asarray(sharded_neighbourhood(jmesh, h, stat)(jnp.asarray(x)))
    got = port["eight"]["stencil"][(h, stat)]
    np.testing.assert_allclose(got, want, atol=1e-5, equal_nan=True)
    single = np.asarray(jnops.neighbourhood(jnp.asarray(x), h, stat))
    np.testing.assert_allclose(got, single, atol=1e-5, equal_nan=True)


def test_large_halo(port, jmesh):
    rng = np.random.default_rng(0)
    x = rng.random((jmesh.shape["y"] * 8, jmesh.shape["x"] * 8)).astype(
        np.float32)
    want = np.asarray(sharded_neighbourhood(jmesh, 4, int(gj.Mean))(
        jnp.asarray(x)))
    np.testing.assert_allclose(port["eight"]["large_halo"], want, atol=1e-5)


def test_halo_deeper_than_a_tile_raises(port):
    assert "deeper than the tile 8 x 8" in port["eight"]["deep_halo"]


def test_sharded_oi_matches_gridpp_tpu(port, jmesh):
    rng = np.random.default_rng(1)
    n, p = 64, 10
    bpoints = gj.Points(np.arange(n) * 500.0, np.zeros(n), np.zeros(n),
                        np.zeros(n), gj.Cartesian)
    points = gj.Points(rng.uniform(0, n * 500.0, p), np.zeros(p),
                       np.zeros(p), np.zeros(p), gj.Cartesian)
    structure = gj.BarnesStructure(2000)
    background = rng.normal(0, 1, n).astype(np.float32)
    pback = rng.normal(0, 1, p).astype(np.float32)
    pobs = pback + rng.normal(0, 0.5, p).astype(np.float32)
    ratios = np.full(p, 0.1, np.float32)
    loc = structure.localization_np(bpoints.lats, bpoints.lons)
    cand, mask = _candidates(bpoints, points, loc, 5)
    o_fields = _resolved_fields(points, structure)
    cj = jnp.asarray(cand)
    out, avar = sharded_oi_kernel(jmesh, structure, 5, True)(
        {k: jnp.asarray(v)[:, None]
         for k, v in _resolved_fields(bpoints, structure).items()},
        {k: jnp.take(jnp.asarray(v), cj, axis=0)
         for k, v in o_fields.items()},
        jnp.asarray(mask), jnp.asarray(background), jnp.ones(n, jnp.float32),
        jnp.take(jnp.asarray(pobs), cj, axis=0),
        jnp.take(jnp.asarray(pback), cj, axis=0),
        jnp.take(jnp.asarray(ratios), cj, axis=0))
    got_out, got_avar = port["eight"]["oi"]
    np.testing.assert_allclose(got_out, np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(got_avar, np.asarray(avar), atol=1e-5)
    expected = gj.optimal_interpolation(bpoints, background, points, pobs,
                                        ratios, pback, structure, 5)
    np.testing.assert_allclose(got_out, expected, atol=1e-5)


@pytest.fixture(scope="module")
def jax_step():
    """gridpp_tpu's distributed step on its in-process 8-device mesh
    (tests/test_distributed.py's problem)."""
    structure, background, p1, obs_f, pobs, pback, ratios = \
        ranks.step_problem()
    mesh = jdist.global_mesh()
    step = jdist.make_distributed_step(mesh, gj.BarnesStructure(100000.0),
                                       halfwidth=3,
                                       statistic=int(Statistic.Mean),
                                       max_points=8,
                                       field_keys=tuple(p1.keys()))
    return np.asarray(step(
        jdist.global_field(background, mesh),
        {k: jdist.global_field(v, mesh) for k, v in p1.items()},
        {k: jdist.replicate(v, mesh) for k, v in obs_f.items()},
        jdist.replicate(pobs, mesh), jdist.replicate(pback, mesh),
        jdist.replicate(ratios, mesh)))


@pytest.mark.parametrize("run", ["eight", "one_rank", "two", "four"])
def test_distributed_step_matches_gridpp_tpu(port, jax_step, run):
    """make_distributed_step on 8 ranks (2 x 4), on each rank's one-rank
    mesh, on 2 hosts (global_mesh() -> (2, 1)) and on a 2 x 2 host grid
    (both-axis host boundaries and corner halos; tests/test_distributed.
    py:58-100), gathered on every rank, against gridpp_tpu's step at
    tests/test_distributed.py:80's bar."""
    if run in ("eight", "one_rank"):
        got = [port["eight"]["step" if run == "eight" else "step_one_rank"]]
    else:
        got = [r[4] for r in port[run]]
        shape = {"two": (2, 1), "four": (2, 2)}[run]
        assert all(r[0] == shape for r in port[run])
        # initialize() inside a running group: safe, and True
        assert all(r[2] is True and r[3] is True for r in port[run])
    for out in got:
        assert out.shape == (64, 64) and np.isfinite(out).all()
        np.testing.assert_allclose(out, jax_step, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("run,host_shape", [("two", None), ("four", (2, 2))])
def test_local_block_slices_are_gridpp_tpus(port, monkeypatch, run,
                                            host_shape):
    n = len(port[run])
    monkeypatch.setattr(jdist.jax, "process_count", lambda: n)
    for rank, r in enumerate(port[run]):
        monkeypatch.setattr(jdist.jax, "process_index", lambda: rank)
        ys, xs = jdist.local_block_slices((64, 64), host_shape)
        assert r[1] == (ys.start, ys.stop, xs.start, xs.stop)


def test_local_block_slices_errors_are_gridpp_tpus():
    for mod in (jdist, tdist):
        with pytest.raises(ValueError, match="must divide host grid"):
            mod.local_block_slices((63, 64), (2, 1))


def test_initialize_without_env_is_a_no_op(monkeypatch):
    for name in ("GRIDPP_COORDINATOR", "GRIDPP_NUM_PROCESSES",
                 "GRIDPP_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize() is False
    assert tdist.initialize() is False
    assert tdist.is_distributed() is False
    mesh = tdist.global_mesh(device="cpu")
    assert mesh.ranks.shape == (1, 1) and mesh.group is None


def test_dryrun_multichip_four_cpu_ranks():
    dryrun_multichip(4, device="cpu", timeout=TIMEOUT)


@pytest.mark.parametrize("source", ["gridpp", "torchrun"])
def test_initialize_from_the_environment(source):
    """Two processes started with GRIDPP_COORDINATOR / _NUM_PROCESSES /
    _PROCESS_ID, or with torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK, join one gloo group through initialize() and lay
    out global_mesh() as (2, 1)."""
    import os
    import subprocess
    import sys

    from gridpp_tpu_torch.parallel.dryrun import _free_port
    port = _free_port()
    code = ("from gridpp_tpu_torch.parallel import distributed as d\n"
            "import torch.distributed as dist\n"
            "assert d.initialize() is True\n"
            "assert d.initialize() is True\n"
            "m = d.global_mesh(device='cpu')\n"
            "print(m.ranks.shape, m.coords, d.is_distributed())\n"
            "dist.destroy_process_group()\n")
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("GRIDPP_", "MASTER_"))
               and k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
        if source == "gridpp":
            env.update(GRIDPP_COORDINATOR=f"localhost:{port}",
                       GRIDPP_NUM_PROCESSES="2", GRIDPP_PROCESS_ID=str(rank))
        else:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ranks.ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            p.kill()
    assert outs == ["(2, 1) (0, 0) True", "(2, 1) (1, 0) True"]
