"""Kernel K1 and the Pipeline on a CUDA card (skipped without one).

This file imports no jax, so it also runs on a machine with the card and
no JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gridpp_tpu_torch as gt  # noqa: E402
from gridpp_tpu_torch.ops import stencil  # noqa: E402

pytestmark = pytest.mark.cuda

STATS = [int(gt.Mean), int(gt.Sum), int(gt.Count)]
TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_pallas_stencil.py:36-38


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _field(shape, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 10, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


@pytest.mark.parametrize("stat", STATS)
@pytest.mark.parametrize("shape,h", [
    ((40, 60), 3), ((17, 250), 7), ((300, 129), 1), ((31, 31), 0),
    ((256, 129), 7), ((160, 128), 3), ((256, 300), 7), ((12, 9), 20),
    ((3, 256, 300), 7), ((2000, 2000), 7)])
def test_kernel_matches_twin(dev, stat, shape, h):
    x = torch.as_tensor(_field(shape, seed=h), device=dev)
    before = stencil.neighbourhood_mean_cuda.launches
    got = gt.neighbourhood(x, h, stat)
    want = gt.neighbourhood(x.cpu(), h, stat)
    torch.cuda.synchronize()
    assert stencil.neighbourhood_mean_cuda.launches == before + (h > 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def test_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros((64, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.neighbourhood_mean_cuda(x.t()[:, :32], 2, 2, 0)
    with pytest.raises(TypeError):
        stencil.neighbourhood_mean_cuda(x.double(), 2, 2, 0)
    big = torch.zeros((4001, 4001), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stencil.neighbourhood_mean_cuda(big, 2000, 2000, 0)


def _problem(seed=7, n=80, n_obs=120):
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n), np.linspace(5, 8, n),
                             indexing="ij")
    grid = gt.Grid(lats, lons)
    pts = gt.Points(rng.uniform(55, 58, n_obs), rng.uniform(5, 8, n_obs),
                    np.zeros(n_obs), np.zeros(n_obs))
    bg = rng.normal(280, 5, (n, n)).astype(np.float32)
    pobs = (bg.reshape(-1)[grid.nearest_map(pts.lats, pts.lons)]
            + rng.normal(0, 2, n_obs)).astype(np.float32)
    return grid, pts, bg, pobs, np.full(n_obs, 0.2, np.float32)


def test_pipeline_on_card(dev):
    grid, pts, bg, pobs, ratios = _problem()
    kw = dict(halfwidth=3, statistic=gt.Mean, max_points=8, tiled=True,
              tile_shape=(16, 32), ratios=ratios)
    card = gt.Pipeline(grid, pts, gt.BarnesStructure(30000.0), device=dev,
                       **kw)
    cpu = gt.Pipeline(grid, pts, gt.BarnesStructure(30000.0), device="cpu",
                      **kw)
    gap = pobs.copy()
    gap[::3] = np.nan
    for po in (pobs, pobs + 1.0, gap):
        bgd, pod = torch.as_tensor(bg, device=dev), torch.as_tensor(
            po, device=dev)
        general = card.run_device(bgd, pod, ratios, path="general")
        resolve = card.run_device(bgd, pod, ratios, path="resolve")
        assert torch.equal(general, resolve)
        want = cpu.run_device(torch.as_tensor(bg), torch.as_tensor(po),
                              ratios, path="general")
        np.testing.assert_allclose(general.cpu().numpy(), want.numpy(),
                                   rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="runs on cuda"):
        card.run_device(torch.as_tensor(bg), torch.as_tensor(pobs))
