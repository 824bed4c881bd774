"""Shared set-up for the gridpp_tpu_torch parity tests.

The same seeded numpy inputs go through gridpp_tpu (the JAX reference, on
the CPU) and gridpp_tpu_torch; results are compared as numpy arrays.
"""
import numpy as np
import pytest
import torch

import gridpp_tpu as gj
import gridpp_tpu_torch as gt

# tier-1 runs several test workers on a shared CPU
torch.set_num_threads(2)


def require_cuda():
    """Skip the calling test unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def problem(seed, n=40, n_obs=60, nan_obs=0.2, elevs=False):
    """A randomized network (tests/test_pipeline_consistency.py:15-29):
    a 40x40 grid over 55-58N 5-8E, BarnesStructure(30 km), ratios 0.2,
    obs = background at the obs + noise with a share missing. Returns the
    numpy inputs; build the objects of either package with `objects`."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 58, n), np.linspace(5, 8, n),
                             indexing="ij")
    plats = rng.uniform(55, 58, n_obs)
    plons = rng.uniform(5, 8, n_obs)
    if elevs:
        pelev = rng.uniform(0, 500, n_obs)
        plaf = rng.uniform(0, 1, n_obs)
        gelev = rng.uniform(0, 500, (n, n)).astype(np.float32)
        glaf = rng.uniform(0, 1, (n, n)).astype(np.float32)
    else:
        pelev = np.zeros(n_obs)
        plaf = np.zeros(n_obs)
        gelev = glaf = None
    background = rng.normal(280, 5, (n, n)).astype(np.float32)
    noise = rng.normal(0, 2, n_obs)
    drop = rng.random(n_obs) < nan_obs
    return dict(lats=lats, lons=lons, plats=plats, plons=plons,
                pelev=pelev, plaf=plaf, gelev=gelev, glaf=glaf,
                background=background, noise=noise, drop=drop,
                ratios=np.full(n_obs, 0.2, np.float32))


def objects(pkg, prob, structure=None):
    """(grid, points, structure) of package `pkg` (gj or gt) for prob."""
    extra = {}
    if prob["gelev"] is not None:
        extra = dict(elevs=prob["gelev"], lafs=prob["glaf"])
    grid = pkg.Grid(prob["lats"], prob["lons"], **extra)
    pts = pkg.Points(prob["plats"], prob["plons"], prob["pelev"],
                     prob["plaf"])
    if structure is None:
        structure = pkg.BarnesStructure(30000.0)
    return grid, pts, structure


def obs_values(prob, grid):
    """(pback, pobs) for prob: the background at the obs through the
    nearest map, and that plus noise with the dropped obs missing."""
    idx = grid.nearest_map(prob["plats"], prob["plons"])
    pback = prob["background"].reshape(-1)[idx]
    pobs = (pback + prob["noise"]).astype(np.float32)
    pobs[prob["drop"]] = np.nan
    return pback, pobs


def ens_problem(seed, n=30, n_obs=50, e=6, nan_obs=0.2, span=3.0):
    """A randomized ensemble network (tests/test_pipeline_consistency.py:
    202-221): an n x n grid over 55-(55+span)N 5-(5+span)E, members
    normal(280, 5), a correlation ensemble beside it, background at the
    obs through the nearest map, obs = member mean + noise with a share
    missing, perturbed obs (P, E) for ebe/ebesc, sigmas 1.5, ratios 0.1."""
    rng = np.random.default_rng(seed)
    lats, lons = np.meshgrid(np.linspace(55, 55 + span, n),
                             np.linspace(5, 5 + span, n), indexing="ij")
    plats = rng.uniform(55, 55 + span, n_obs)
    plons = rng.uniform(5, 5 + span, n_obs)
    background = rng.normal(280, 5, (n, n, e)).astype(np.float32)
    background_corr = (background + rng.normal(0, 1, background.shape)
                       ).astype(np.float32)
    idx = gt.Grid(lats, lons).nearest_map(plats, plons)
    pback = background.reshape(-1, e)[idx]
    pbackc = background_corr.reshape(-1, e)[idx]
    pobs = (pback.mean(axis=1) + rng.normal(0, 2, n_obs)).astype(np.float32)
    pobs_e = (pback + rng.normal(0, 1, (n_obs, e))).astype(np.float32)
    drop = rng.random(n_obs) < nan_obs
    pobs[drop] = np.nan
    pobs_e[drop] = np.nan
    return dict(lats=lats, lons=lons, plats=plats, plons=plons,
                pelev=np.zeros(n_obs), plaf=np.zeros(n_obs), gelev=None,
                glaf=None, background=background,
                background_corr=background_corr, pback=pback,
                pbackc=pbackc, pobs=pobs, pobs_e=pobs_e,
                psig=np.full(n_obs, 1.5, np.float32),
                ratios=np.full(n_obs, 0.1, np.float32),
                bratios=np.ones((n, n), np.float32))


def tensor(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), device=device)


def spy(monkeypatch, module, name):
    """Count the calls of module.name for the rest of the test: returns
    the list the wrapper appends to on each call."""
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls
