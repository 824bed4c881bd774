"""Fused post-processing pipeline: the serving path, on a torch device.

The counterpart of gridpp_tpu's `Pipeline`: neighbourhood smoothing of the
background, the background at the obs through the cached nearest map, and
OI from a per-gridpoint shortlist of the `candidates` highest-rho
observations that is computed once, on the host, at construction
(ops/canonical.py). A cycle only masks the candidates whose obs are
invalid this cycle, re-selects the top max_points among the survivors,
solves, and adds the weighted innovations.

All geometry lives on the device given to the constructor, and a cycle's
tensors must already be there: `run_device` raises on a tensor that is on
another device rather than moving it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import Statistic
from ..core.grid import Grid
from ..core.points import Points
from ..ops import oi_tiled as tiled_ops
from ..ops.canonical import canonical_shortlist
from ..ops.neighbourhood import neighbourhood
from ..ops.oi import oi_block_from_candidates
from .oi import _origin, _resolved_fields

__all__ = ["Pipeline"]

_PATHS = ("auto", "fast", "general", "resolve")
_GEOM_TYPES = {"tile_table": torch.int32, "local_idx": torch.int32,
               "rho": torch.float32, "valid": torch.bool,
               "tile_static": torch.float32}
_WEIGHT_TYPES = {"local_s": torch.int32, "valid_s": torch.bool,
                 "weights": torch.float32, "a_scalar": torch.float32}


def _as_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Pipeline:
    """Neighbourhood-smooth + deterministic OI, fused on one device.

    Parameters mirror gridpp_tpu.Pipeline:
      grid: background Grid
      points: observation Points (static network)
      structure: StructureFunction for the OI
      halfwidth/statistic: neighbourhood filter settings (halfwidth=0
        disables smoothing). Any statistic ops.neighbourhood takes: on the
        card Mean/Sum/Count, Min/Max and Std/Variance run kernels K1, K2
        and K3, the others the plain brute force. Quantile (which needs a
        level) and RandomChoice raise ValueError on the first cycle, as
        in gridpp_tpu.
      max_points: OI localization cap
      candidates: size of the cached shortlist per gridpoint (>=
        max_points; the extra slots absorb observations that go missing
        in a given cycle). Default 2x max_points.
      tiled: tile-union path (default: grids of >= 65,536 points)
      ratios: static obs error ratios; enables the fast path
      device: where the geometry lives and every cycle runs
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 halfwidth: int = 0, statistic: int = Statistic.Mean,
                 max_points: int = 10, allow_extrapolation: bool = True,
                 block: int = 16384, candidates: int | None = None,
                 tiled: bool | None = None, tile_shape=(32, 64),
                 ratios=None, *, device):
        self.device = _as_device(device)
        self.grid = grid
        self.points = points
        self.structure = structure
        self.shape = tuple(grid.size())
        self.halfwidth = int(halfwidth)
        self.statistic = int(statistic)
        self.max_points = int(max_points)
        self.allow = bool(allow_extrapolation)
        bpoints = grid.to_points()
        origin = _origin(bpoints)
        self._obs_nn = torch.as_tensor(
            grid.nearest_map(points.lats, points.lons, cache_obj=points),
            device=self.device).long()
        n = self.shape[0] * self.shape[1]
        n_obs = points.size()
        if candidates is None:
            candidates = 2 * self.max_points if self.max_points > 0 else n_obs
        k_cap = max(1, min(int(candidates), n_obs))

        # One-time canonical host selection: the stored order and rho bits
        # are identical to gridpp_tpu's (ops/canonical.py).
        sl = canonical_shortlist(bpoints, points, structure, k_cap)

        self._static_w = None
        self._gw_state = None
        self._init_ratios = (None if ratios is None
                             else np.asarray(ratios, np.float32))
        self.tiled = n >= 65536 if tiled is None else bool(tiled)
        if self.tiled:
            static_np = _resolved_fields(points, structure, origin)
            self._geom = tiled_ops.build_tile_tables(
                sl.sel, sl.rho, sl.valid, static_np, self.shape,
                th=tile_shape[0], tw=tile_shape[1])
            self.load_state(self._geom_arrays(self._geom))
            return

        self._obs_fields = {
            key: torch.as_tensor(v, device=self.device)
            for key, v in _resolved_fields(points, structure, origin).items()}
        nb = -(-n // block)
        pad = nb * block - n

        def blocked(v, fill):
            v = np.concatenate([v, np.full((pad,) + v.shape[1:], fill,
                                           v.dtype)])
            return torch.as_tensor(v.reshape(nb, block, k_cap),
                                   device=self.device)

        self._block = block
        self._cand = (blocked(sl.sel, 0), blocked(sl.rho, 0),
                      blocked(sl.valid, False))

    # -- state ----------------------------------------------------------
    @staticmethod
    def _geom_arrays(geom):
        return {"tile_table": geom.tile_table, "local_idx": geom.local_idx,
                "rho": geom.rho, "valid": geom.valid,
                "tile_static": geom.tile_static,
                "static_keys": list(geom.static_keys)}

    def load_state(self, arrays):
        """Load the tiled path's device state from numpy arrays.

        arrays: tile_table, local_idx, rho, valid, tile_static and
        static_keys (gridpp_tpu's TileGeometry names), and optionally the
        static weights local_s, valid_s, weights, a_scalar. Without the
        weights they are built here when the Pipeline has static ratios.
        The cached weights of the general path are dropped.
        """
        if not self.tiled:
            raise ValueError("load_state needs a tiled Pipeline")
        self._geom_dev = {
            key: torch.tensor(np.asarray(arrays[key]), dtype=dt,
                              device=self.device)
            for key, dt in _GEOM_TYPES.items()}
        self._static_keys = tuple(arrays["static_keys"])
        self._gw_state = None
        if "weights" in arrays:
            self._static_w = {
                key: torch.tensor(np.asarray(arrays[key]), dtype=dt,
                                  device=self.device)
                for key, dt in _WEIGHT_TYPES.items()}
        elif self._init_ratios is not None:
            self._static_w = tiled_ops.build_static_weights(
                self.structure, self._geom_dev, self._static_keys,
                torch.as_tensor(self._init_ratios, device=self.device),
                self.max_points)
        else:
            self._static_w = None

    def state(self):
        """The tiled path's device state as numpy arrays (see load_state)."""
        if not self.tiled:
            raise ValueError("state needs a tiled Pipeline")
        out = {key: v.cpu().numpy() for key, v in self._geom_dev.items()}
        out["static_keys"] = list(self._static_keys)
        if self._static_w is not None:
            out.update({key: v.cpu().numpy()
                        for key, v in self._static_w.items()})
        return out

    # -- one cycle --------------------------------------------------------
    def _smooth(self, background):
        if self.halfwidth > 0:
            return neighbourhood(background, self.halfwidth, self.statistic)
        return background

    def _inputs(self, background, pobs):
        """Smoothed background, background at the obs, 0/1 validity."""
        smoothed = self._smooth(background)
        pback = smoothed.reshape(-1)[self._obs_nn]
        valid01 = (torch.isfinite(pobs)
                   & torch.isfinite(pback)).to(torch.float32)
        return smoothed, pback, valid01

    def _run_flat(self, background, pobs, pratios):
        smoothed = self._smooth(background)
        flat = smoothed.reshape(-1)
        pback = flat[self._obs_nn]
        n = flat.shape[0]
        sel, rho, valid = self._cand
        bg = torch.full((sel.shape[0] * self._block,), torch.nan,
                        device=flat.device)
        bg[:n] = flat
        bg = bg.reshape(sel.shape[0], self._block)
        outs = [oi_block_from_candidates(
            self.structure, sel[i], rho[i], valid[i], self._obs_fields,
            bg[i], torch.ones_like(bg[i]), pobs, pback, pratios,
            self.max_points, self.allow)[0] for i in range(sel.shape[0])]
        return torch.cat(outs)[:n].reshape(self.shape)

    def _run_resolve(self, background, pobs, pratios):
        """The full tiled re-solve."""
        smoothed, pback, valid01 = self._inputs(background, pobs)
        ok = valid01 > 0
        packed = torch.stack([torch.where(ok, pobs, 0.0),
                              torch.where(ok, pback, 0.0),
                              pratios, valid01], dim=1)
        bg_t = tiled_ops.tile_fields(smoothed, self._geom)
        out_t, _ = tiled_ops.oi_tiled_sweep(
            self.structure, self._geom_dev, self._static_keys, bg_t,
            torch.ones_like(bg_t), packed, self.max_points, self.allow)
        return tiled_ops.untile_fields(out_t, self._geom)

    def _run_guarded(self, background, pobs, pratios):
        """The general path: gain rows cached across cycles and rebuilt
        only when the obs validity or the ratios change. Equal to the
        re-solve bit for bit: both build the gain rows with
        build_weights_dynamic and apply them with oi_tiled_apply_weights,
        on the same shapes. The guard reads one flag on the host per
        cycle (gridpp_tpu branches on the device with lax.cond)."""
        smoothed, pback, valid01 = self._inputs(background, pobs)
        st = self._gw_state
        changed = st is None or bool(
            torch.any(valid01 != st["valid"])
            | torch.any(pratios != st["ratios"]))
        if changed:
            st = self._gw_state = {
                "valid": valid01, "ratios": pratios.clone(),
                "weights": tiled_ops.build_weights_dynamic(
                    self.structure, self._geom_dev, self._static_keys,
                    pratios, valid01, self.max_points)}
        innov = torch.where(valid01 > 0, pobs - pback, 0.0)
        out_t = tiled_ops.oi_tiled_apply_weights(
            st["weights"], self._geom_dev["tile_table"],
            tiled_ops.tile_fields(smoothed, self._geom), innov, self.allow)
        return tiled_ops.untile_fields(out_t, self._geom)

    def _run_fast(self, background, pobs):
        """Static-network path: gain rows fixed at construction."""
        smoothed = self._smooth(background)
        innov = pobs - smoothed.reshape(-1)[self._obs_nn]
        out_t = tiled_ops.oi_tiled_apply_weights(
            self._static_w, self._geom_dev["tile_table"],
            tiled_ops.tile_fields(smoothed, self._geom), innov, self.allow)
        return tiled_ops.untile_fields(out_t, self._geom)

    # -- entry points -------------------------------------------------------
    def _check(self, t, name):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}; this Pipeline runs "
                             f"on {self.device}")

    def _ratios(self, pratios):
        if pratios is None:
            pratios = self._init_ratios
        if pratios is None:
            raise ValueError("pratios required (Pipeline built without "
                             "ratios)")
        if isinstance(pratios, torch.Tensor):
            self._check(pratios, "pratios")
            return pratios.to(torch.float32)
        return torch.as_tensor(np.asarray(pratios, np.float32),
                               device=self.device)

    def _fast_eligible(self, pratios):
        if self._static_w is None:
            return False
        if pratios is None:
            return True
        if isinstance(pratios, torch.Tensor):
            pratios = pratios.cpu().numpy()
        return np.array_equal(np.asarray(pratios, np.float32),
                              self._init_ratios)

    def _run(self, background, pobs, pratios):
        if self.tiled:
            return self._run_guarded(background, pobs, pratios)
        return self._run_flat(background, pobs, pratios)

    def run_device(self, background, pobs, pratios=None,
                   assume_valid=False, path="auto"):
        """One cycle, device to device. background: (Y, X) and pobs: (P,)
        f32 tensors on this Pipeline's device. Returns (Y, X).

        assume_valid=True skips the all-finite check (one host sync) when
        the caller has validated the cycle's inputs. path: "auto" (fast
        when eligible), "fast" (require the static-ratios weight path),
        "general" (on tiled grids, the cached gain rows rebuilt only when
        obs validity or ratios change) or "resolve" (the full tiled
        re-solve every cycle).
        """
        if path not in _PATHS:
            raise ValueError(f"path must be one of {_PATHS}")
        self._check(background, "background")
        self._check(pobs, "pobs")
        if path in ("general", "resolve"):
            pratios = self._ratios(pratios)
            if path == "resolve" and self.tiled:
                return self._run_resolve(background, pobs, pratios)
            return self._run(background, pobs, pratios)
        if path == "fast" and self._static_w is None:
            raise ValueError("Pipeline was built without static ratios")
        if self._fast_eligible(pratios):
            if assume_valid or bool(torch.isfinite(pobs).all()
                                    & torch.isfinite(background).all()):
                return self._run_fast(background, pobs)
        return self._run(background, pobs, self._ratios(pratios))

    def _upload(self, background, pobs):
        bg = np.asarray(background, np.float32)
        po = np.asarray(pobs, np.float32)
        ok = bool(np.isfinite(po).all() and np.isfinite(bg).all())
        return (torch.as_tensor(bg, device=self.device),
                torch.as_tensor(po, device=self.device), ok)

    def __call__(self, background, pobs, pratios=None):
        """numpy in, numpy out: background (Y, X), pobs/pratios (P,).
        pratios may be omitted when the Pipeline was built with ratios."""
        bg, po, ok = self._upload(background, pobs)
        return self.run_device(bg, po, pratios, assume_valid=ok).cpu().numpy()

    def serve_stream(self, cycles):
        """Serve an iterable of host cycles (background, pobs[, pratios]);
        yields (Y, X) numpy analyses in order. Cycle N + 1 is queued on the
        device before cycle N's result is copied to the host."""
        def run_one(args):
            bg, po, ok = self._upload(args[0], args[1])
            pr = args[2] if len(args) > 2 else None
            return self.run_device(bg, po, pr, assume_valid=ok)

        prev = None
        for args in cycles:
            out = run_one(args)
            if prev is not None:
                yield prev.cpu().numpy()
            prev = out
        if prev is not None:
            yield prev.cpu().numpy()
