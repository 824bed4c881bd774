"""Fused post-processing pipelines: the serving paths, on a torch device.

The counterparts of gridpp_tpu's `Pipeline`, `EnsiPipeline` and
`MultiEnsiPipeline`: neighbourhood smoothing of the background, the
background at the obs through the cached nearest map, and OI from a
per-gridpoint shortlist of the `candidates` highest-rho observations that
is computed once, on the host, at construction (ops/canonical.py). A cycle
only masks the candidates whose obs are invalid this cycle, re-selects the
top max_points among the survivors, and runs the update: the
deterministic solve, the local ensemble transform (EnSI) or one of the
ensi_multi schemes (ebe, ebesc, utem).

All geometry lives on the device given to the constructor, and a cycle's
tensors must already be there: `run_device` raises on a tensor that is on
another device rather than moving it.

On a card, a tiled Pipeline's fast and general cycles are captured CUDA
graphs (ops/graph.py), the counterparts of gridpp_tpu's jitted cycles: the
first call of a path runs eagerly and captures its graph, later calls
replay it. The general path's guard branches on the device, under a
conditional graph node, as gridpp_tpu's does under lax.cond, so neither
path waits on the host after its first call. The resolve path and the flat
(small-grid) path stay eager, as do the ensemble pipelines; on the CPU
every path runs eagerly and the guard branches on the host.
"""
from __future__ import annotations

import weakref
from collections import deque

import numpy as np
import torch

from ..constants import Statistic
from ..core.grid import Grid
from ..core.points import Points
from ..native import stage as host_stage
from ..ops import graph
from ..ops import oi_ensi_multi as mops
from ..ops import oi_tiled as tiled_ops
from ..ops import stencil
from ..ops.canonical import canonical_shortlist
from ..ops.neighbourhood import neighbourhood
from ..ops.oi import oi_block_from_candidates
from ..ops.oi_ensi import (_s_cap, _shortlist_sweep, _table,
                           obs_anomalies)
from ..tracing import count, span
from .oi import _origin, _resolved_fields

__all__ = ["Pipeline", "EnsiPipeline", "MultiEnsiPipeline"]

_PATHS = ("auto", "fast", "general", "resolve")
_GEOM_TYPES = {"tile_table": torch.int32, "local_idx": torch.int32,
               "rho": torch.float32, "valid": torch.bool,
               "tile_static": torch.float32}
_WEIGHT_TYPES = {"local_s": torch.int32, "valid_s": torch.bool,
                 "weights": torch.float32, "a_scalar": torch.float32}
_RING = 4   # pinned staging buffers of numpy pratios, used in turn
_SPARE = 2  # released output arrays a pipeline keeps for later yields


def _host_if(pred, body):
    """The guard's branch on the CPU: read the flag, run body if set."""
    if pred.is_cuda:
        raise RuntimeError("the guard's flag is not read on the host on a "
                           "card")
    if bool(pred):
        body()


def _run_body(pred, body):
    """The guard's branch in a graph's first, eager cycle: its state is
    fresh (init 0), so the flag is set without reading it."""
    body()


def _as_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host_f32(arrays):
    """numpy arrays -> f32 numpy arrays (native/stage.py's as_f32), and
    whether every value is finite (checked on the host: no device round
    trip)."""
    host = host_stage.as_f32(arrays)
    return host, all(bool(np.isfinite(a).all()) for a in host)


def _serve_stream(pipe, run_one, cycles, n_up=None):
    """Serve an iterable of host cycles on pipe's device, yielding numpy
    results in order. The first n_up arrays of a cycle (all by default) are
    uploaded as f32 tensors; run_one(tensors, ok, args) queues the cycle on
    the device and returns its output tensor (ok: every uploaded value is
    finite).

    Cycle N + 1 is queued before cycle N's result is copied to the host, so
    on a card cycle N's download runs while cycle N + 1 computes, and cycle
    N + 1's upload while cycle N does (_serve_card). On the CPU the loop is
    the same without streams."""
    if pipe.device.type == "cuda":
        return _serve_card(pipe.device, pipe._copy_streams(),
                           pipe._spare_outputs(), run_one, cycles, n_up)
    return _serve_plain(pipe, run_one, cycles, n_up)


def _serve_plain(pipe, run_one, cycles, n_up):
    prev = None     # (output, its cycle), not yet fetched

    def fetch(out, i):
        with span("gridpp.serve.fetch", i):
            res = out.cpu().numpy()
        count("serve.cycles")
        return res

    for i, args in enumerate(cycles):
        with span("gridpp.serve.check", i):
            host, ok = _host_f32(args[:n_up])
        with span("gridpp.serve.stage", i):
            tensors = [torch.as_tensor(a, device=pipe.device) for a in host]
        with span("gridpp.cycle", i):
            out = run_one(tensors, ok, args)
        if prev is not None:
            yield fetch(*prev)
        prev = (out, i)
    if prev is not None:
        yield fetch(*prev)


def _pinned(buf, shape, dtype):
    """buf if it has this shape and type, else a new pinned host tensor."""
    if buf is not None and buf.shape == shape and buf.dtype == dtype:
        return buf
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class _Lease:
    """The base of an array that _hand_out yields: it lends out a pooled
    buffer's memory, which goes back to the pool once the lease, and so
    the yield and every view of it, is gone."""
    __slots__ = ("__array_interface__", "__weakref__")


def _hand_out(spare, src):
    """A numpy copy of the host tensor src, in a buffer from spare (a
    deque of released buffers; one of another shape or type is dropped),
    else in a fresh one. A buffer of 160 MB is above malloc's mmap
    threshold, so a fresh one is mapped anew and faults in every page
    during the copy; a released one is mapped already. The buffer joins
    spare again once the yield and all its views are gone, so a yield
    stays the caller's for as long as any view of it lives."""
    while True:
        try:
            buf = spare.pop()
        except IndexError:
            buf = torch.empty(src.shape, dtype=src.dtype)
            count("serve.fetch.fresh")
            break
        if buf.shape == src.shape and buf.dtype == src.dtype:
            count("serve.fetch.recycled")
            break
    buf.copy_(src)
    lease = _Lease()
    lease.__array_interface__ = buf.numpy().__array_interface__
    weakref.finalize(lease, spare.append, buf)
    return np.asarray(lease)


def _serve_card(device, streams, spare, run_one, cycles, n_up):
    """_serve_stream on a card. Compute runs on the caller's current
    stream. A cycle's arrays are staged into pinned buffers, two sets used
    in turn, so cycle N + 1 is staged while cycle N's upload may still read
    its set, and uploaded on the first copy stream of `streams`, which the
    compute stream waits on by an event. Cycle N's output is copied down on
    the second, behind an event recorded after its compute, once cycle
    N + 1 is queued. The host waits on that copy's event alone and yields
    a copy of the pinned buffer, made by torch into one of `spare`'s
    released arrays where there is one (_hand_out), so a yielded array
    stays the caller's while the buffer serves the next cycle. A cycle's
    arrays go into the pinned buffers by one host pass that also checks
    their finiteness (native/stage.py, on torch's intra-op threads)."""
    compute = torch.cuda.current_stream(device)
    up, down = streams
    staged = [[], []]           # each set's pinned input buffers
    uploaded = [None, None]     # each set's last upload, as an event
    fetched = None              # the pinned output buffer
    prev = None                 # (output, its compute's event, its cycle),
                                # not yet down

    def download(out, done, i):
        nonlocal fetched
        with span("gridpp.serve.fetch", i):
            fetched = _pinned(fetched, out.shape, out.dtype)
            with torch.cuda.stream(down):
                down.wait_event(done)
                fetched.copy_(out, non_blocking=True)
                out.record_stream(down)
                copied = down.record_event()
            with span("gridpp.serve.fetch.wait"):
                copied.synchronize()
            res = _hand_out(spare, fetched)
        count("serve.cycles")
        return res

    for i, args in enumerate(cycles):
        with span("gridpp.serve.check", i):
            host = host_stage.as_f32(args[:n_up])
        s = i % 2
        with span("gridpp.serve.stage", i):
            if uploaded[s] is not None:
                with span("gridpp.serve.stage.wait"):
                    uploaded[s].synchronize()
            old = staged[s]
            staged[s] = [_pinned(old[j] if j < len(old) else None, a.shape,
                                 torch.float32) for j, a in enumerate(host)]
            ok = host_stage.stage(host, staged[s])
            with torch.cuda.stream(up):
                tensors = [buf.to(device, non_blocking=True)
                           for buf in staged[s]]
                uploaded[s] = up.record_event()
            compute.wait_event(uploaded[s])
            for t in tensors:
                t.record_stream(compute)
        with span("gridpp.cycle", i):
            out = run_one(tensors, ok, args)
            done = compute.record_event()
        if i == 0:
            # the call's other pinned buffers now, behind the first cycle's
            # compute, so that a call after a one-cycle warm-up finds them
            # all in torch's pinned-memory cache (a new one costs tens of ms)
            staged[1] = [_pinned(None, b.shape, b.dtype) for b in staged[0]]
            fetched = _pinned(None, out.shape, out.dtype)
        if prev is not None:
            yield download(*prev)
        prev = (out, done, i)
    if prev is not None:
        yield download(*prev)


def _obs_nn(grid, points, device):
    """The flat index of each obs' nearest gridpoint, on `device`."""
    return torch.as_tensor(
        grid.nearest_map(points.lats, points.lons, cache_obj=points),
        device=device).long()


def _shortlist(grid, points, structure, max_points: int, candidates):
    """The canonical shortlist of the `candidates` (default 2 x
    max_points) highest-rho obs of every gridpoint, and its width k_cap.
    Its order and rho bits are gridpp_tpu's (ops/canonical.py)."""
    n_obs = points.size()
    if candidates is None:
        candidates = 2 * max_points if max_points > 0 else n_obs
    k_cap = max(1, min(int(candidates), n_obs))
    return canonical_shortlist(grid.to_points(), points, structure,
                               k_cap), k_cap


class _OnDevice:
    """A pipeline whose state lives on `self.device`."""

    def _check(self, t, name):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}; this "
                             f"{type(self).__name__} runs on {self.device}")

    def _copy_streams(self):
        """serve_stream's upload and download streams on the card, made
        once a pipeline: the caching allocator keeps a stream's freed
        blocks for that stream, so a later call allocates nothing new."""
        if getattr(self, "_streams", None) is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        return self._streams

    def _spare_outputs(self):
        """serve_stream's released output arrays on the card (_hand_out),
        kept once a pipeline, so that a call after a warm-up call reuses
        the warm-up's."""
        if getattr(self, "_spare", None) is None:
            self._spare = deque(maxlen=_SPARE)
        return self._spare

    def _upload(self, *arrays):
        """numpy arrays -> f32 tensors on this device, and whether every
        value is finite (_host_f32)."""
        host, ok = _host_f32(arrays)
        return [torch.as_tensor(a, device=self.device) for a in host], ok


class Pipeline(_OnDevice):
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
        origin = _origin(grid.to_points())
        self._obs_nn = _obs_nn(grid, points, self.device)
        n = self.shape[0] * self.shape[1]
        # one-time host selection
        sl, k_cap = _shortlist(grid, points, structure, self.max_points,
                               candidates)

        self._static_w = None
        self._init_ratios = (None if ratios is None
                             else np.asarray(ratios, np.float32))
        # the static ratios' device copy, and the pinned staging ring of
        # other numpy pratios (_stage)
        self._init_dev = (None if ratios is None else torch.as_tensor(
            self._init_ratios, device=self.device))
        self._ring = [[None, None] for _ in range(_RING)]
        self._ring_next = 0
        self._graphs = {}
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
        The general path's guard starts afresh (its cached weights and
        `rebuilds` count), and the captured graphs are dropped: every
        geometry address changes.
        """
        if not self.tiled:
            raise ValueError("load_state needs a tiled Pipeline")
        for g in self._graphs.values():
            g.close()
        self._graphs = {}
        self._geom_dev = {
            key: torch.tensor(np.asarray(arrays[key]), dtype=dt,
                              device=self.device)
            for key, dt in _GEOM_TYPES.items()}
        self._static_keys = tuple(arrays["static_keys"])
        if "weights" in arrays:
            self._static_w = {
                key: torch.tensor(np.asarray(arrays[key]), dtype=dt,
                                  device=self.device)
                for key, dt in _WEIGHT_TYPES.items()}
        elif self._init_ratios is not None:
            self._static_w = tiled_ops.build_static_weights(
                self.structure, self._geom_dev, self._static_keys,
                self._init_dev, self.max_points)
        else:
            self._static_w = None
        self._guard = self._zero_guard()
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)

    def _zero_guard(self):
        """The general path's guard state on the device, allocated once:
        gridpp_tpu's zero_state() (gridpp_tpu/api/pipeline.py:271-280) and
        the a_scalar rows, plus `rebuilds`, the count of rebuilt cycles."""
        t_count, tb, k_cap = self._geom_dev["local_idx"].shape
        s_cap = min(self.max_points, k_cap) if self.max_points > 0 \
            else k_cap
        n_obs = self.points.size()

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        state = {key: zeros((t_count, tb) if key == "a_scalar"
                            else (t_count, tb, s_cap), dt)
                 for key, dt in _WEIGHT_TYPES.items()}
        state.update(init=zeros((), torch.int32),
                     valid=zeros(n_obs, torch.float32),
                     ratios=zeros(n_obs, torch.float32),
                     rebuilds=zeros((), torch.int64))
        return state

    @property
    def rebuilds(self) -> torch.Tensor:
        """How many general cycles rebuilt the cached weights since
        construction or load_state: a 0-dim int64 tensor on this device
        (reading it waits for the device)."""
        if not self.tiled:
            raise ValueError("rebuilds needs a tiled Pipeline")
        return self._guard["rebuilds"]

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

    def _run_guarded(self, background, pobs, pratios, branch=_host_if,
                     out=None):
        """The general path: gain rows cached across cycles in the guard's
        buffers and rebuilt only when the obs validity or the ratios
        change. Equal to the re-solve bit for bit: both build the gain rows
        with build_weights_dynamic and apply them with
        oi_tiled_apply_weights, on the same shapes. branch(changed,
        rebuild) takes the guard's branch: on the host on the CPU, as a
        conditional node of the graph on a card (gridpp_tpu: lax.cond).
        out: the (T, TB) tensor the analysis tiles go to (the graph's
        static buffer), or None."""
        smoothed, pback, valid01 = self._inputs(background, pobs)
        st = self._guard
        changed = ((st["init"] == 0) | torch.any(valid01 != st["valid"])
                   | torch.any(pratios != st["ratios"]))

        def rebuild():
            tiled_ops.build_weights_dynamic(
                self.structure, self._geom_dev, self._static_keys, pratios,
                valid01, self.max_points, out=st)
            st["valid"].copy_(valid01)
            st["ratios"].copy_(pratios)
            st["init"].fill_(1)
            st["rebuilds"].add_(1)

        branch(changed, rebuild)
        innov = torch.where(valid01 > 0, pobs - pback, 0.0)
        out_t = tiled_ops.oi_tiled_apply_weights(
            st, self._geom_dev["tile_table"],
            tiled_ops.tile_fields(smoothed, self._geom), innov, self.allow,
            out=out)
        return tiled_ops.untile_fields(out_t, self._geom)

    def _run_fast(self, background, pobs, branch=None, out=None):
        """Static-network path: gain rows fixed at construction (no
        branch; out as in _run_guarded)."""
        smoothed = self._smooth(background)
        innov = pobs - smoothed.reshape(-1)[self._obs_nn]
        out_t = tiled_ops.oi_tiled_apply_weights(
            self._static_w, self._geom_dev["tile_table"],
            tiled_ops.tile_fields(smoothed, self._geom), innov, self.allow,
            out=out)
        return tiled_ops.untile_fields(out_t, self._geom)

    def _cycle(self, path, run, *args):
        """One fast or general cycle of a tiled grid: eager on the CPU. On
        a card the path's first call runs eagerly on its graph's stream
        (its answer is returned), then captures the cycle on static
        buffers; later calls replay the graph (ops/graph.Graphed). A
        capture that fails raises."""
        if self.device.type != "cuda":
            return run(*args)
        g = self._graphs.get(path)
        if g is not None:
            return g(*args)
        with span("gridpp.cycle.capture"):
            g = graph.Graphed(self.device, self._pool)
            first = g.warm(lambda: run(*args, branch=_run_body))
            tiles = g.buffer(self._geom_dev["local_idx"].shape[:2])
            g.capture(lambda *a: run(*a, branch=g.if_node, out=tiles), args)
        self._graphs[path] = g
        return first

    # -- entry points -------------------------------------------------------
    def _ratios(self, pratios):
        """pratios as an f32 tensor on this device, with no host wait on a
        card: None and numpy ratios equal to the static ones give their
        device copy, other numpy ratios go up through a pinned buffer
        (_stage), a tensor goes as it is."""
        if pratios is None:
            if self._init_dev is None:
                raise ValueError("pratios required (Pipeline built without "
                                 "ratios)")
            return self._init_dev
        if isinstance(pratios, torch.Tensor):
            self._check(pratios, "pratios")
            return pratios.to(torch.float32)
        host = np.asarray(pratios, np.float32)
        if self._init_ratios is not None and np.array_equal(
                host, self._init_ratios):
            return self._init_dev
        if self.device.type == "cuda":
            return self._stage(host)
        return torch.as_tensor(host, device=self.device)

    def _stage(self, host):
        """host (numpy f32) on the card by a non-blocking copy from the
        next pinned buffer of the ring. The host refills a buffer only
        after the event of its last copy, so it never overwrites one that
        a queued copy still reads."""
        slot = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % _RING
        buf, copied = slot
        if buf is None or tuple(buf.shape) != host.shape:
            buf = torch.empty(host.shape, dtype=torch.float32,
                              pin_memory=True)
        elif copied is not None:
            copied.synchronize()
        buf.numpy()[...] = host
        out = buf.to(self.device, non_blocking=True)
        slot[:] = [buf, torch.cuda.current_stream(self.device).record_event()]
        return out

    def _fast_eligible(self, pratios):
        if self._static_w is None:
            return False
        if pratios is None:
            return True
        if isinstance(pratios, torch.Tensor):
            with span("gridpp.cycle.sync"):
                pratios = pratios.cpu().numpy()
            count("host.sync")
        return np.array_equal(np.asarray(pratios, np.float32),
                              self._init_ratios)

    def _run(self, background, pobs, pratios):
        if self.tiled:
            count("cycle.general")
            return self._cycle("general", self._run_guarded, background,
                               pobs, pratios)
        count("cycle.flat")
        return self._run_flat(background, pobs, pratios)

    def _all_finite(self, background, pobs) -> bool:
        """Whether every value of both is finite: a host read of the
        device's answer."""
        with span("gridpp.cycle.sync"):
            ok = bool(torch.isfinite(pobs).all()
                      & torch.isfinite(background).all())
        count("host.sync")
        return ok

    def run_device(self, background, pobs, pratios=None,
                   assume_valid=False, path="auto"):
        """One cycle, device to device. background: (Y, X) and pobs: (P,)
        f32 tensors on this Pipeline's device. Returns (Y, X).

        assume_valid=True skips the all-finite check (one host sync) when
        the caller has validated the cycle's inputs. path: "auto" (fast
        when eligible), "fast" (require the static-ratios weight path),
        "general" (on tiled grids, the cached gain rows rebuilt only when
        obs validity or ratios change) or "resolve" (the full tiled
        re-solve every cycle, eager). On a card, after a path's first call
        a tiled fast or general cycle is a graph replay that waits on
        nothing on the host, with pratios None, numpy or a tensor, but for
        a tensor pratios on path "auto" (copied down to compare with the
        static ratios) and the all-finite check without assume_valid.
        The returned tensor is the caller's: later cycles leave it as is.
        """
        if path not in _PATHS:
            raise ValueError(f"path must be one of {_PATHS}")
        self._check(background, "background")
        self._check(pobs, "pobs")
        if path in ("general", "resolve"):
            pratios = self._ratios(pratios)
            if path == "resolve" and self.tiled:
                count("cycle.resolve")
                return self._run_resolve(background, pobs, pratios)
            return self._run(background, pobs, pratios)
        if path == "fast" and self._static_w is None:
            raise ValueError("Pipeline was built without static ratios")
        if self._fast_eligible(pratios):
            if assume_valid or self._all_finite(background, pobs):
                count("cycle.fast")
                return self._cycle("fast", self._run_fast, background, pobs)
        return self._run(background, pobs, self._ratios(pratios))

    def __call__(self, background, pobs, pratios=None):
        """numpy in, numpy out: background (Y, X), pobs/pratios (P,).
        pratios may be omitted when the Pipeline was built with ratios."""
        (bg, po), ok = self._upload(background, pobs)
        return self.run_device(bg, po, pratios, assume_valid=ok).cpu().numpy()

    def serve_stream(self, cycles):
        """Serve an iterable of host cycles (background, pobs[, pratios]);
        yields (Y, X) numpy analyses in order (see _serve_stream).
        pratios stays on the host, as in __call__."""
        def run_one(tensors, ok, args):
            pr = args[2] if len(args) > 2 else None
            return self.run_device(*tensors, pr, assume_valid=ok)

        return _serve_stream(self, run_one, cycles, n_up=2)


class _EnsembleBase(_OnDevice):
    """Shared set-up of the ensemble pipelines: the obs nearest map and the
    canonical shortlist (sel, rho, valid), each (N, K) on the device."""

    def __init__(self, grid: Grid, points: Points, structure, max_points,
                 allow_extrapolation, block, candidates, device):
        self.device = _as_device(device)
        self.grid = grid
        self.points = points
        self.structure = structure
        self.shape = tuple(grid.size())
        self.max_points = int(max_points)
        self.allow = bool(allow_extrapolation)
        self.block = int(block)
        self._n = self.shape[0] * self.shape[1]
        self._obs_nn = _obs_nn(grid, points, self.device)
        sl, k_cap = _shortlist(grid, points, structure, self.max_points,
                               candidates)
        self._s_cap = _s_cap(self.max_points, k_cap)
        self._cand = (torch.as_tensor(sl.sel, device=self.device).long(),
                      torch.as_tensor(sl.rho, device=self.device),
                      torch.as_tensor(sl.valid, device=self.device))

    def _check_field(self, t, name):
        self._check(t, name)
        if t.dim() != 3 or tuple(t.shape[:2]) != self.shape:
            raise ValueError(f"{name} must be (Y, X, E) with (Y, X) = "
                             f"{self.shape}, got {tuple(t.shape)}")


class EnsiPipeline(_EnsembleBase):
    """Ensemble OI (EnSI) serving path on one device (gridpp_tpu
    EnsiPipeline).

    A forecast cycle takes the member fields (Y, X, E) and the obs vectors,
    smooths every member (halfwidth > 0), gathers the background at the obs
    through the cached nearest map, masks the shortlist candidates whose obs
    are invalid, re-selects the top max_points and runs the local ensemble
    transform (ops/oi_ensi). Matches optimal_interpolation_ensi whenever
    >= max_points shortlist candidates carry valid obs (candidates >
    max_points is the slack).

    Smoothing, by statistic: Mean/Sum/Count/Min/Max are one launch of the
    member stencil K5 on the (Y, X, E) field (ops.stencil.
    neighbourhood_members); Std/Variance one batched K3 launch on the
    (E, Y, X) planes; other statistics the plain brute force. A statistic
    gridpp_tpu rejects (Quantile without a level, RandomChoice) raises on
    the first cycle, as there.

    block: gridpoints per batch of the transform; the result does not
    depend on it. device: where the shortlist lives and every cycle runs.
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 halfwidth: int = 0, statistic: int = Statistic.Mean,
                 max_points: int = 10, allow_extrapolation: bool = True,
                 block: int = 1 << 20, candidates: int | None = None, *,
                 device):
        super().__init__(grid, points, structure, max_points,
                         allow_extrapolation, block, candidates, device)
        self.halfwidth = int(halfwidth)
        self.statistic = int(statistic)
        # Static-prefix selection for the all-valid fast path: the
        # shortlist is sorted by rho, so with every obs valid the per-cycle
        # re-selection returns exactly its first s_cap entries
        self._cand_fast = tuple(t[:, :self._s_cap].contiguous()
                                for t in self._cand)

    def _smooth(self, background):
        h, stat = self.halfwidth, self.statistic
        if h == 0:
            return background
        if stat in stencil.MEMBER_STATS:
            return stencil.neighbourhood_members(background, h, stat)
        planes = background.permute(2, 0, 1)
        return neighbourhood(planes, h, stat).permute(1, 2, 0)

    def run_device(self, background, pobs, psigmas, assume_valid=False):
        """One cycle, device to device: background (Y, X, E), pobs/psigmas
        (P,) f32 tensors on this pipeline's device. Returns (analysis
        (Y, X, E), n_cond_failures), the count a device scalar (no host
        sync).

        assume_valid=True asserts every obs, sigma and background value is
        finite this cycle; the re-selection then reduces to the shortlist
        prefix (bit-identical output)."""
        self._check_field(background, "background")
        self._check(pobs, "pobs")
        self._check(psigmas, "psigmas")
        e = background.shape[2]
        count("cycle.ensi_prefix" if assume_valid else "cycle.ensi")
        # contiguous rows: torch's CPU reductions over E vectorise a strided
        # layout by shape, and a row's result must not depend on the block
        flat = self._smooth(background).reshape(self._n, e).contiguous()
        y_hat, y_anom = obs_anomalies(flat[self._obs_nn])
        out, cond_bad = _shortlist_sweep(
            self._cand_fast if assume_valid else self._cand, flat,
            _table(pobs, psigmas, y_hat, y_anom), torch.isfinite(pobs),
            self._s_cap, self.block, self.allow, prefix=assume_valid)
        return out.reshape(self.shape + (e,)), cond_bad.sum()

    def __call__(self, background, pobs, psigmas):
        """numpy in, numpy out (one upload, one download)."""
        args, ok = self._upload(background, pobs, psigmas)
        return self.run_device(*args, assume_valid=ok)[0].cpu().numpy()

    def serve_stream(self, cycles):
        """Serve an iterable of host cycles (background, pobs, psigmas);
        yields (Y, X, E) numpy analyses in order (see _serve_stream)."""
        def run_one(tensors, ok, args):
            return self.run_device(*tensors, assume_valid=ok)[0]

        return _serve_stream(self, run_one, cycles)


_VARIANTS = ("ebe", "ebesc", "utem")


class MultiEnsiPipeline(_EnsembleBase):
    """Serving path of the ensi_multi family (ebe/ebesc/utem) on one device
    (gridpp_tpu MultiEnsiPipeline).

    Same shortlist design as EnsiPipeline; each cycle gathers the
    background (and background_corr) at the obs through the cached nearest
    map, builds one packed per-obs table, masks candidates with invalid
    obs, re-selects the top max_points and runs the member update (ebe,
    ebesc) or the ETKF transform (utem) of ops/oi_ensi_multi. Matches the
    host API (optimal_interpolation_ensi_multi_*) when every member is
    valid at every gridpoint and >= max_points shortlist candidates carry
    valid obs.

    bratios: (Y, X) background error ratios, default 1.
    """

    def __init__(self, grid: Grid, points: Points, structure,
                 variant: str = "ebesc", max_points: int = 10,
                 allow_extrapolation: bool = True, block: int = 1 << 20,
                 candidates: int | None = None, bratios=None, *, device):
        if variant not in _VARIANTS:
            raise ValueError("variant must be one of ebe/ebesc/utem")
        super().__init__(grid, points, structure, max_points,
                         allow_extrapolation, block, candidates, device)
        self.variant = variant
        if bratios is None:
            br = np.ones(self._n, np.float32)
        else:
            br = np.asarray(bratios, np.float32).reshape(-1)
            if br.shape[0] != self._n:
                raise ValueError("Bratios and grid size mismatch")
        self._bratios = torch.as_tensor(br, device=self.device)
        obs_fields = _resolved_fields(points, structure,
                                      _origin(grid.to_points()))
        self._field_keys = tuple(obs_fields)
        self._obs_tab_fields = torch.as_tensor(
            np.stack([obs_fields[k] for k in self._field_keys], axis=1),
            device=self.device)  # (P, F)

    def run_device(self, background, pobs, pratios, background_corr=None):
        """One cycle, device to device.

        background: (Y, X, E). pobs: (P, E) for ebe/ebesc, (P,) for utem.
        pratios: (P,). background_corr: (Y, X, E), required for ebe and
        utem (the dynamic-correlation ensemble); ignored for ebesc.
        Returns (analysis (Y, X, E), n_condition_failures device scalar).
        """
        if self.variant != "ebesc" and background_corr is None:
            raise ValueError(f"background_corr required for {self.variant}")
        self._check_field(background, "background")
        self._check(pobs, "pobs")
        self._check(pratios, "pratios")
        e = background.shape[2]
        count("cycle.multi")
        bg = background.reshape(self._n, e).contiguous()  # see EnsiPipeline
        bgc = None
        if self.variant != "ebesc":
            self._check_field(background_corr, "background_corr")
            bgc = background_corr.reshape(self._n, e).contiguous()
        if self.variant == "utem":
            count("cycle.utem")
            with span("gridpp.cycle.table"):
                tab = mops.utem_table(pobs, pratios, bg[self._obs_nn],
                                      bgc[self._obs_nn])
            out, n_cond = mops.utem_serve_sweep(
                bg, bgc, self._bratios, tab, torch.isfinite(pobs),
                self._cand, self._s_cap, self.block, self.allow)
        else:
            pback = bg[self._obs_nn]  # (P, E)
            ebe = bgc is not None
            out = mops.member_serve_sweep(
                self.structure, self._field_keys, bg, self._bratios,
                mops.norm_anom(bgc) if ebe else None,
                mops.member_table(self._obs_tab_fields, pratios,
                                  pobs - pback,
                                  bgc[self._obs_nn] if ebe else None),
                torch.isfinite(pobs[:, 0]), self._cand, self._s_cap,
                self.block, self.allow)
            n_cond = torch.zeros((), dtype=torch.int64, device=self.device)
        return out.reshape(self.shape + (e,)), n_cond

    def __call__(self, background, pobs, pratios, background_corr=None):
        """numpy in, numpy out (one upload, one download)."""
        extra = () if background_corr is None else (background_corr,)
        args, _ = self._upload(background, pobs, pratios, *extra)
        return self.run_device(*args)[0].cpu().numpy()

    def serve_stream(self, cycles):
        """Serve an iterable of host cycles (background, pobs, pratios[,
        background_corr]); yields (Y, X, E) numpy analyses in order (see
        _serve_stream)."""
        return _serve_stream(
            self, lambda tensors, ok, args: self.run_device(*tensors)[0],
            cycles)
