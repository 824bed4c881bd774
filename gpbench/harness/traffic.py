"""The one traffic generator: every configuration's and mix's arrays,
drawn from the seed.

A configuration file gives the grid (`grid`: ny, nx and the lat/lon box
of a regular grid), the number of uniformly placed `stations`, the
`field` distribution (normal mean and std, float32), `members` (0 for a
deterministic field (Y, X), else (Y, X, E)), `obs_noise_std` and, for an
ensemble, `psigmas`. A mix file gives `missing_fraction`, the share of
the stations set to NaN in each cycle, drawn anew for every cycle (0:
none). The harness's own: a pool of POOL host cycles drawn at set-up and
used in turn, and WARMUP cycles served before the window.
A cycle i takes pool slot i mod POOL and gets `i // POOL + 1` times 2^-10
added to one row (the stamp row, the grid's middle row) before it is
handed over, so no two cycles carry equal inputs and a slot's fields pass
through the host's caches as fresh fields do. Obs of a slot are the
slot's field at each station's nearest gridpoint (the members' mean there)
plus normal noise.

Stations and missing sets are drawn with NumPy from the seed; fields and
noise on the device given, with a torch.Generator seeded with the seed, in
one call a slot.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import geometry

STAMP = 2.0 ** -10
POOL = 16
WARMUP = 3


class Traffic:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        g = config["grid"]
        self.ny, self.nx = int(g["ny"]), int(g["nx"])
        self.lats, self.lons = np.meshgrid(
            np.linspace(g["lat"][0], g["lat"][1], self.ny),
            np.linspace(g["lon"][0], g["lon"][1], self.nx), indexing="ij")
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed, 0])
        p = int(config["stations"])
        self.plats = rng.uniform(g["lat"][0], g["lat"][1], p)
        self.plons = rng.uniform(g["lon"][0], g["lon"][1], p)
        self.nn = geometry.nearest(self.lats, self.lons, self.plats,
                                   self.plons)
        self.members = int(config.get("members", 0))
        shape = (self.ny, self.nx) + ((self.members,) if self.members
                                      else ())
        self.missing = int(round(float(traffic["missing_fraction"]) * p))
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        f = config["field"]
        self.fields = [torch.normal(
            float(f["mean"]), float(f["std"]), shape, generator=gen,
            device=device).cpu().numpy() for _ in range(POOL)]
        noise = torch.normal(0.0, float(config["obs_noise_std"]),
                             (POOL, p), generator=gen,
                             device=device).cpu().numpy()
        self.obs = [(self._truth(fl) + noise[s]).astype(np.float32)
                    for s, fl in enumerate(self.fields)]
        self.row = self.ny // 2
        self.base = [fl[self.row].copy() for fl in self.fields]
        self.psig = (np.full(p, float(config["psigmas"]), np.float32)
                     if "psigmas" in config else None)

    def _truth(self, field):
        flat = field.reshape(self.ny * self.nx, -1)[self.nn]
        return flat.mean(axis=1)

    def stamp(self, i: int) -> np.float32:
        return np.float32((i // POOL + 1) * STAMP)

    def missing_set(self, i: int) -> np.ndarray:
        """Station ids set to NaN in cycle i."""
        if not self.missing:
            return np.zeros(0, np.int64)
        rng = np.random.default_rng([self.seed, 1, i])
        return rng.choice(len(self.plats), self.missing, replace=False)

    def _obs(self, i: int):
        obs = self.obs[i % POOL]
        if self.missing:
            obs = obs.copy()
            obs[self.missing_set(i)] = np.nan
        return obs

    def _args(self, field, obs):
        return (field, obs) if self.psig is None else (field, obs, self.psig)

    def make(self, i: int):
        """Cycle i's arrays for the program: the pool slot, stamped in
        place (a slot is reused only POOL cycles later)."""
        s = i % POOL
        field = self.fields[s]
        field[self.row] = self.base[s] + self.stamp(i)
        return self._args(field, self._obs(i))

    def inputs(self, i: int):
        """Cycle i's arrays as make(i) hands them, in fresh copies."""
        s = i % POOL
        field = self.fields[s].copy()
        field[self.row] = self.base[s] + self.stamp(i)
        return self._args(field, self._obs(i))
