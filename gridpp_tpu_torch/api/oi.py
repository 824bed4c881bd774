"""Optimal interpolation API (gridpp_tpu/api/oi.py, reference
src/api/oi.cpp).

Host orchestration: validate, flatten, drop the invalid observations, find
each gridpoint's candidates once, then solve the gridpoints in blocks. The
route follows the API's device, read once per call (api/_common.api_device):

- host (the CPU; the top-level package pins its functions there): the
  threaded native C++ solver (csrc oi_host_solve) for the product-kernel
  structures, the plain torch block solver (ops/oi.oi_gather_block) on CPU
  tensors for the others;
- device (the card when there is one, or any other default device): the
  canonical-shortlist sweep (ops/oi.oi_shortlist_sweep), the selection the
  serving pipelines use; when a truncated row is starved this cycle, the
  dense all-obs sweep (ops/oi.oi_dense_sweep) for moderate networks, else
  the host-candidate block solver on the device. Nothing on this route
  moves to the CPU.

Device tensors cached on Points objects are keyed on the device, so host
and device calls in one process never share them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.points import Points
from ..ops.oi import (_blocks, oi_dense_sweep, oi_gather_block,
                      oi_shortlist_sweep)
from ._common import api_device, asarray_f32, on_host, upload

__all__ = ["optimal_interpolation", "optimal_interpolation_full"]

# Gridpoints per block: bounds peak memory of the (B, S, S) covariance
# assembly
_BLOCK = 524288


def _point_fields(xyz, elevs, lafs, idx=None):
    if idx is None:
        return {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                "elev": elevs.astype(np.float64),
                "laf": lafs.astype(np.float64)}
    return {"x": xyz[idx, 0], "y": xyz[idx, 1], "z": xyz[idx, 2],
            "elev": elevs[idx].astype(np.float64),
            "laf": lafs[idx].astype(np.float64)}


_BALL_QUERY_MAX = 262_144


def _candidates(bpoints: Points, opts: Points, loc, max_points):
    """Padded in-radius candidate lists (cand, mask) or None when empty.

    Small problems use the exact ball query. Large grids avoid its Python
    lists (millions of them at 2000^2) and take dense arrays from the tree:

    - max_points > 0: k-nearest-within-radius, with k GROWN until every
      gridpoint's k-th neighbour lies beyond its localization radius, so
      the shortlist provably contains every in-radius observation. This
      keeps top-rho selection exact even when elev/laf kernels make rho
      non-monotone in distance (reference semantics: oi.cpp:233-281).
    - max_points = 0 (every in-radius observation): `_ball_fetch`, the
      ball query's lists in blocks of rows, in its order (ascending
      observation index), as the small problems get them. A k-nearest
      query with k = the network's size would take 640 GB at 2000^2 and
      10k observations.
    """
    n = bpoints.size()
    loc = np.asarray(loc, np.float64)
    n_obs = opts.size()
    # Cache on the background points: obs networks and localization scales
    # are static across forecast cycles, so the padded candidate arrays are
    # reused while only obs *values* change.
    cache = bpoints.__dict__.setdefault("_cand_cache", {})
    key = (n_obs, hash(opts.lats.tobytes()), hash(opts.lons.tobytes()),
           float(loc.min()) if loc.size else 0.0,
           float(loc.max()) if loc.size else 0.0,
           float(loc.sum()) if loc.size else 0.0, int(max_points))
    if key in cache:
        return cache[key]
    obs_tree = opts.index.tree
    bxyz = bpoints.xyz
    if n <= _BALL_QUERY_MAX:
        if loc.size and np.all(loc == loc.ravel()[0]):
            lists = obs_tree.query_ball_point(bxyz, r=float(loc.ravel()[0]),
                                              workers=-1)
        else:
            lists = obs_tree.query_ball_point(bxyz, r=loc, workers=-1)
        counts = np.fromiter((len(l) for l in lists), dtype=np.int64,
                             count=len(lists))
        kmax = int(counts.max()) if counts.size else 0
        if kmax == 0:
            return None
        cand = np.zeros((n, kmax), dtype=np.int32)
        mask = np.zeros((n, kmax), dtype=bool)
        for i, lst in enumerate(lists):
            c = len(lst)
            if c:
                cand[i, :c] = lst
                mask[i, :c] = True
    elif max_points <= 0:
        res = _ball_fetch(obs_tree, bxyz, np.broadcast_to(loc, (n,)), n_obs)
        if res is None:
            return None
        cand, mask = res
    else:
        k_cand = min(n_obs, max(4 * max_points, 32) if max_points > 0
                     else n_obs)
        rmax = float(loc.max()) if loc.size else 0.0
        dist, cand = obs_tree.query(bxyz, k=k_cand,
                                    distance_upper_bound=rmax, workers=-1)
        if k_cand == 1:
            dist = dist[:, None]
            cand = cand[:, None]
        # Exactness: a row's shortlist is complete once its k-th neighbour
        # distance exceeds its localization radius (an infinite k-th
        # distance means fewer than k obs exist within rmax). Re-query the
        # incomplete rows with a larger k until all rows are complete.
        if k_cand < n_obs:
            locv = loc if loc.ndim else np.full(n, float(loc))
            incomplete = np.nonzero(dist[:, -1] <= locv)[0]
            while incomplete.size and k_cand < n_obs:
                k_new = min(4 * k_cand, n_obs)
                d2, c2 = obs_tree.query(bxyz[incomplete], k=k_new,
                                        distance_upper_bound=rmax,
                                        workers=-1)
                grow = k_new - k_cand
                dist = np.pad(dist, ((0, 0), (0, grow)),
                              constant_values=np.inf)
                cand = np.pad(cand, ((0, 0), (0, grow)),
                              constant_values=n_obs)
                dist[incomplete] = d2
                cand[incomplete] = c2
                k_cand = k_new
                if k_cand >= n_obs:
                    break
                incomplete = incomplete[d2[:, -1] <= locv[incomplete]]
        mask = dist <= loc[:, None]
        cand = np.where(mask, cand, 0).astype(np.int32)
        if not mask.any():
            return None
    if len(cache) > 8:
        cache.clear()
    cache[key] = (cand, mask)
    return cand, mask


def _ball_fetch(tree, xyz, loc, n_obs):
    """The ball query's lists of every row of xyz (radius loc, per row) as
    padded (cand, mask) in its order (ascending observation index), or
    None when every list is empty; in blocks of _BALL_QUERY_MAX rows.

    The ball query counts each row's observations, a k-nearest query (k
    the longest count) fetches them and each row is sorted into the ball
    query's order. A row whose fetched set is not the ball query's (a
    distance within an ulp of its radius) takes the ball query's own
    list."""
    n = xyz.shape[0]
    blocks = _blocks(n, _BALL_QUERY_MAX)

    def radius(rows):
        locb = loc[rows]
        return float(locb[0]) if np.all(locb == locb[0]) else locb

    lens = np.concatenate([
        tree.query_ball_point(xyz[rows], r=radius(rows), workers=-1,
                              return_length=True) for rows in blocks])
    kmax = int(lens.max())
    if kmax == 0:
        return None
    cand = np.empty((n, kmax), np.int32)
    for rows in blocks:
        locb = loc[rows]
        dist, idx = tree.query(
            xyz[rows], k=kmax, workers=-1,
            distance_upper_bound=np.nextafter(locb.max(), np.inf))
        idx = np.where(dist.reshape(idx.shape[0], -1) <= locb[:, None],
                       idx.reshape(idx.shape[0], -1), n_obs)
        idx.sort(axis=1)
        cand[rows] = idx
    mask = cand < n_obs
    for i in np.nonzero(mask.sum(axis=1) != lens)[0]:
        lst = sorted(tree.query_ball_point(xyz[i], r=float(loc[i])))
        cand[i, :len(lst)] = lst
        mask[i] = np.arange(kmax) < len(lst)
    cand[~mask] = 0
    return cand, mask


def _candidate_tensors(pts: Points, cand, mask, dev):
    """cand (int32) and mask as tensors on dev, cached on pts per candidate
    array and device: a grid's candidate lists are static across calls, so
    they are uploaded once."""
    cache = pts.__dict__.setdefault("_cand_dev_cache", {})
    key = (id(cand), dev)
    if key not in cache:
        if len(cache) > 2:
            cache.clear()
        # the arrays stay referenced, so their ids are not reused
        cache[key] = (cand, mask, upload(cand, dev), upload(mask, dev))
    return cache[key][2:]


def _candidates_block(bpoints: Points, opts: Points, loc, start, end,
                      obs_key):
    """Exact ball-query candidates for one gridpoint block [start, end).

    Used by the host path on large grids: the global padded array would
    need kmax columns for ALL gridpoints (10+ GB at 2000^2 with a dense
    network), while per-block arrays stay bounded and cache per block.
    kmax is rounded up to a power of two so the blocks share a few
    shapes.
    """
    cache = bpoints.__dict__.setdefault("_cand_block_cache", {})
    key = (obs_key, int(start), int(end))
    if key in cache:
        return cache[key]
    bxyz = bpoints.xyz[start:end]
    locb = loc[start:end]
    obs_tree = opts.index.tree
    if locb.size and np.all(locb == locb.ravel()[0]):
        lists = obs_tree.query_ball_point(bxyz, r=float(locb.ravel()[0]),
                                          workers=-1)
    else:
        lists = obs_tree.query_ball_point(bxyz, r=locb, workers=-1)
    counts = np.fromiter((len(l) for l in lists), dtype=np.int64,
                         count=len(lists))
    kmax = int(counts.max()) if counts.size else 0
    if kmax == 0:
        cache[key] = None
        return None
    kpad = 8
    while kpad < kmax:
        kpad *= 2
    nb = end - start
    cand = np.zeros((nb, kpad), dtype=np.int32)
    mask = np.zeros((nb, kpad), dtype=bool)
    for i, lst in enumerate(lists):
        c = len(lst)
        if c:
            cand[i, :c] = lst
            mask[i, :c] = True
    if len(cache) > 64:
        cache.clear()
    cache[key] = (cand, mask)
    return cand, mask


def _resolved_fields(pts: Points, structure, origin=None) -> dict:
    """Point fields with structure length scales resolved (host).

    When `origin` (an ECEF centroid) is given, coordinates are shifted to
    it and cast to float32: translation leaves all chord distances
    unchanged while restoring full f32 precision near the domain (absolute
    ECEF values ~6.4e6 m would quantize to ~0.5 m steps in f32).
    """
    fields = _point_fields(pts.xyz, pts.elevs, pts.lafs)
    fields["lat"] = pts.lats.astype(np.float64)
    fields["lon"] = pts.lons.astype(np.float64)
    fields = structure.resolve_p1_np(fields)
    fields.pop("lat", None)
    fields.pop("lon", None)
    if origin is not None:
        for i, key in enumerate(("x", "y", "z")):
            fields[key] = (fields[key] - origin[i]).astype(np.float32)
        for key in fields:
            fields[key] = np.asarray(fields[key], np.float32)
    return fields


def _with_scales(fields, structure, count):
    """Field dict + per-point h/v/w arrays (scalar structures broadcast
    their scale attributes) for the native solvers."""
    out = dict(fields)
    for key in ("h", "v", "w"):
        if key not in out:
            out[key] = np.full(count, float(getattr(structure, key, 0.0)),
                               np.float32)
    return out


def _native_kernel_type(structure):
    """Native rho-kernel id for structures the C++ OI solver supports.

    Exact-type match: subclasses may override _corr, and
    Multiple/CrossValidation/Linear have non-product or value-based
    correlation semantics the native kernel does not implement.
    """
    from ..structure import (BarnesStructure, CressmanStructure,
                             PowerlawStructure, SoarStructure,
                             ToarStructure)
    return {BarnesStructure: 0, CressmanStructure: 1, SoarStructure: 2,
            ToarStructure: 3, PowerlawStructure: 4}.get(type(structure))


def _chunked_shortlist(bpoints, opts, structure, loc, max_points, n):
    """Canonical shortlist feed for the chunked native host paths
    (OI and EnSI), or None when the per-block ball queries are the
    better precompute.

    `opts` holds only valid observations (the callers pre-filter,
    oi.cpp:250-260), so the canonical top-k_cap by rho
    (ops/canonical.py; the same native pair evaluator the solvers'
    in-kernel select_topk runs) provably contains the exact top
    max_points for every gridpoint: feeding the solvers from it is
    bit-identical to the exact ball queries. It wins when the shortlist
    is cheap (monotone rho order: obs elev/laf uniform, so the k-NN
    proposal is complete with no growth, and the solver scans
    4*max_points candidates instead of the in-radius count) or when the
    network is dense (the ball path materializes millions of scipy Python
    lists whose cost grows with the in-radius count). Sparse networks with
    active vertical/laf kernels (where the rho bound cannot prune) keep
    the ball path. max_points <= 0 means "use every in-radius obs", which
    a capped shortlist cannot serve.
    """
    if int(max_points) <= 0:
        return None
    from ..ops.canonical import canonical_shortlist, monotone_obs
    use_sl = monotone_obs(structure, opts)
    if not use_sl:
        # sampled mean in-radius count; gridpp_tpu measured the crossover
        # between ~100 (ball faster) and ~360 (shortlist faster)
        step = max(1, n // 2048)
        cts = opts.index.radius_counts(
            bpoints.lats[::step], bpoints.lons[::step],
            float(np.max(loc)) if np.asarray(loc).size else 0.0)
        use_sl = cts.size > 0 and float(cts.mean()) >= 192.0
    if not use_sl:
        return None
    k_cap = min(opts.size(), max(4 * int(max_points), 32))
    return canonical_shortlist(bpoints, opts, structure, k_cap)


def _oi_native(bpoints, opts, loc, structure, kt, p1_np, o_np, pobs_k,
               pbg_k, pratios_k, background, bvariance, max_points,
               allow_extrapolation, chunked, cand, mask, obs_key):
    """Run the threaded native per-gridpoint OI solve (csrc
    oi_host_solve); returns (analysis, avariance) or None when the
    native engine is unavailable."""
    from .. import native
    if native.get_lib() is None:
        return None
    n = bpoints.size()

    gfx = _with_scales(p1_np, structure, n)
    gfx["loc"] = np.asarray(loc, np.float32)
    ofx = _with_scales(o_np, structure, opts.size())
    ofx["loc"] = np.asarray(
        structure.localization_np(opts.lats, opts.lons), np.float32)

    if not chunked:
        return native.oi_host_solve(
            gfx, ofx, pobs_k, pbg_k, pratios_k, cand, mask, kt,
            int(max_points), bool(allow_extrapolation), background,
            bvariance)

    sl = _chunked_shortlist(bpoints, opts, structure, loc, max_points, n)

    out = np.asarray(background, np.float32).copy()
    avar = np.asarray(bvariance, np.float32).copy()
    for start in range(0, n, _BLOCK):
        end = min(start + _BLOCK, n)
        if sl is not None:
            res_b = (sl.sel[start:end], sl.valid[start:end])
        else:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:
                continue
        gfb = {k: v[start:end] for k, v in gfx.items()}
        res = native.oi_host_solve(
            gfb, ofx, pobs_k, pbg_k, pratios_k, res_b[0], res_b[1], kt,
            int(max_points), bool(allow_extrapolation),
            background[start:end], bvariance[start:end])
        if res is None:
            return None
        out[start:end] = res[0]
        avar[start:end] = res[1]
    return out, avar


def _host_arrays(fields):
    """numpy views of a dict of CPU tensors."""
    return {k: v.numpy() for k, v in fields.items()}


def _oi_points(bpoints: Points, background, bvariance, points: Points,
               pobs, obs_variance, pbackground, bvariance_at_points,
               structure, max_points, allow_extrapolation, dev, host):
    """Points-form optimal_interpolation_full (oi.cpp:138-341) on device
    `dev`; `host` selects the host route."""
    n = bpoints.size()
    ns = points.size()
    background = np.asarray(background, np.float32)
    bvariance = np.asarray(bvariance, np.float32)
    output = background.copy()
    avar = bvariance.copy()
    if ns == 0:
        return output, avar

    pratios = np.asarray(obs_variance, np.float32) / np.asarray(
        bvariance_at_points, np.float32)
    pobs = np.asarray(pobs, np.float32)
    pbackground = np.asarray(pbackground, np.float32)

    # Pre-filter observations with invalid values (oi.cpp:250-260): they can
    # never be selected, so drop them from the candidate pool entirely.
    keep = np.isfinite(pobs) & np.isfinite(pbackground)
    if not keep.any():
        return output, avar
    kidx = np.nonzero(keep)[0]
    opts = points.subset(kidx)
    pobs_k = pobs[kidx]
    pbg_k = pbackground[kidx]
    pratios_k = pratios[kidx]

    # Canonical-shortlist device route: selection order and rho come from
    # the cached host-computed shortlist (ops/canonical.py), so the
    # selection is the serving pipelines' and the native solvers'. It
    # falls back to the full-depth paths below when a truncated gridpoint
    # keeps fewer than max_points valid candidates this cycle (the
    # reference digs deeper, oi.cpp:250-281).
    if not host and max_points > 0:
        res_sl = _oi_points_shortlist(
            bpoints, background, bvariance, points, pobs, pratios,
            pbackground, structure, max_points, allow_extrapolation, dev)
        if res_sl is not None:
            return res_sl

    # Dense device route: with a moderate observation count, rho against
    # every observation on the device (no host spatial query, no candidate
    # arrays to upload). Every structure zeroes rho beyond its
    # localization distance, so rho > 0 is the radius query. On the host
    # the cached tree query is far cheaper than an all-pairs sweep.
    if (not host and 0 < opts.size() <= 32768
            and n * opts.size() > 4_000_000):
        return _oi_points_dense(bpoints, background, bvariance, opts,
                                pobs_k, pratios_k, pbg_k, structure,
                                max_points, allow_extrapolation, dev)

    # Localization radii (may vary per gridpoint for spatial structures)
    loc = structure.localization_np(bpoints.lats, bpoints.lons)

    # On large host grids, candidates are queried (and cached) per block:
    # a single global padded array needs max-in-radius columns for every
    # gridpoint, which is GBs at 2000^2 with a dense network.
    chunked = host and n > _BALL_QUERY_MAX
    if not chunked:
        res = _candidates(bpoints, opts, loc, max_points)
        if res is None:
            return output, avar
        cand, mask = res
    obs_key = (opts.size(), hash(opts.lats.tobytes()),
               hash(opts.lons.tobytes()),
               float(loc.min()) if loc.size else 0.0,
               float(loc.max()) if loc.size else 0.0)
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(opts, structure, origin, dev)
    if host:
        # Threaded native solver for the product-kernel structures (f32
        # semantics, one thread per core); exotic structures
        # (Multiple/CrossValidation/Linear) keep the torch block solver.
        kt = _native_kernel_type(structure)
        if kt is not None:
            res_nat = _oi_native(
                bpoints, opts, loc, structure, kt, _host_arrays(p1_all),
                _host_arrays(o_fields), pobs_k, pbg_k, pratios_k,
                background, bvariance, max_points, allow_extrapolation,
                chunked, None if chunked else cand,
                None if chunked else mask, obs_key)
            if res_nat is not None:
                return res_nat

    def t(a):
        return torch.as_tensor(a, device=dev)

    t_obs, t_bg, t_ratios = t(pobs_k), t(pbg_k), t(pratios_k)
    bg_t, bvar_t = t(background), t(bvariance)
    out_t, avar_t = bg_t.clone(), bvar_t.clone()
    for start in range(0, n, _BLOCK):
        end = min(start + _BLOCK, n)
        if chunked:
            res_b = _candidates_block(bpoints, opts, loc, start, end,
                                      obs_key)
            if res_b is None:  # no obs in radius for this whole block
                continue
            cand_b, mask_b = res_b
        else:
            cand_b, mask_b = cand[start:end], mask[start:end]
        p1 = {k: v[start:end, None] for k, v in p1_all.items()}
        out_t[start:end], avar_t[start:end] = oi_gather_block(
            structure, p1, o_fields, t(cand_b), t(mask_b),
            bg_t[start:end], bvar_t[start:end], t_obs, t_bg, t_ratios,
            int(max_points), bool(allow_extrapolation))
    return out_t.cpu().numpy(), avar_t.cpu().numpy()


def _origin(bpoints):
    cached = bpoints.__dict__.get("_origin_cache")
    if cached is None:
        cached = bpoints.xyz.mean(axis=0)
        bpoints.__dict__["_origin_cache"] = cached
    return cached


def _device_fields(pts: Points, structure, origin, dev) -> dict:
    """Resolved point fields as f32 tensors on `dev`, cached on the points
    object per device: grid coordinates are static across forecast
    cycles, so they are uploaded once."""
    cache = pts.__dict__.setdefault("_dev_field_cache", {})
    spatial_id = id(structure) if getattr(structure, "is_spatial", False) \
        else None
    key = (spatial_id, tuple(np.round(origin, 3)), dev)
    if key not in cache:
        fields = _resolved_fields(pts, structure, origin)
        if len(cache) > 4:
            cache.clear()
        cache[key] = {k: torch.as_tensor(v, device=dev)
                      for k, v in fields.items()}
    return cache[key]


def _oi_points_dense(bpoints, background, bvariance, opts, pobs_k,
                     pratios_k, pbg_k, structure, max_points,
                     allow_extrapolation, dev):
    """OI with rho against every valid observation, on the device: only
    obs values and the background are uploaded per call."""
    p = opts.size()
    origin = _origin(bpoints)
    p1_all = _device_fields(bpoints, structure, origin, dev)
    o_fields = _device_fields(opts, structure, origin, dev)
    # rows per block capped so the (B, P) rho matrix stays ~1 GB
    block = max(8192, min(_BLOCK, (1 << 28) // max(p, 1)))
    out, avar = oi_dense_sweep(
        structure, p1_all, o_fields,
        *(torch.as_tensor(a, device=dev) for a in (
            background, bvariance, pobs_k, pbg_k, pratios_k)),
        int(max_points), bool(allow_extrapolation), block)
    return out.cpu().numpy(), avar.cpu().numpy()


def _shortlist_dev(bpoints, points, structure, k_cap, dev):
    """Canonical shortlist and its tensors on `dev`, cached on bpoints per
    device. The shortlist itself (ops/canonical.py) is device-free and
    shared with the serving pipelines built on the same grid, points and
    structure objects.

    Returns (sel (N, K) int64, rho, valid, truncated, CanonicalShortlist).
    """
    from ..ops.canonical import canonical_shortlist
    sl = canonical_shortlist(bpoints, points, structure, k_cap)
    cache = bpoints.__dict__.setdefault("_canon_dev_cache", {})
    key = (id(sl), dev)
    hit = cache.get(key)
    if hit is None:
        if len(cache) > 4:
            cache.clear()
        hit = (torch.as_tensor(sl.sel, device=dev).long(),
               torch.as_tensor(sl.rho, device=dev),
               torch.as_tensor(sl.valid, device=dev),
               torch.as_tensor(sl.truncated, device=dev), sl)
        cache[key] = hit
    return hit


def _oi_points_shortlist(bpoints, background, bvariance, points, pobs,
                         pratios, pbackground, structure, max_points,
                         allow_extrapolation, dev):
    """Device OI from the canonical shortlist (see _oi_points).

    Returns (analysis, avariance) or None when any truncated gridpoint
    is starved this cycle (caller falls back to a full-depth path).
    """
    n_obs = points.size()
    k_cap = min(n_obs, max(2 * int(max_points), 16))
    sel, rho, valid, truncated, sl = _shortlist_dev(bpoints, points,
                                                    structure, k_cap, dev)
    o_fields = _device_fields(points, structure, _origin(bpoints), dev)
    block = max(16384, min(_BLOCK, (1 << 27) // max(sl.k_cap, 1)))
    out, avar, starved = oi_shortlist_sweep(
        structure, sel, rho, valid, truncated, o_fields,
        *(torch.as_tensor(a, device=dev) for a in (
            background, bvariance, pobs, pbackground, pratios)),
        int(max_points), bool(allow_extrapolation), block)
    if int(starved) > 0:  # the call's one read of a device value
        return None
    return out.cpu().numpy(), avar.cpu().numpy()


def _validate_oi(bobj, background, points, pobs, extra_vecs, names):
    if bobj.get_coordinate_type() != points.get_coordinate_type():
        raise ValueError(
            "Both background and observations points must be of same "
            "coordinate type (lat/lon or x/y)")
    if isinstance(bobj, Grid):
        gy, gx = bobj.size()
        if background.shape != (gy, gx):
            raise ValueError(
                f"input field ({background.shape[0]},{background.shape[1]}) "
                f"is not the same size as the grid ({gy},{gx})")
    else:
        if background.shape[0] != bobj.size():
            raise ValueError(
                f"Input field ({bobj.size()}) is not the same size as the "
                f"grid ({background.shape[0]})")
    if pobs.shape[0] != points.size():
        raise ValueError(
            f"Observations ({pobs.shape[0]}) and points ({points.size()}) "
            "size mismatch")
    for v, name in zip(extra_vecs, names):
        if v.shape[0] != points.size():
            raise ValueError(
                f"{name} ({v.shape[0]}) and points ({points.size()}) size "
                "mismatch")


def optimal_interpolation(bgrid, background, points, pobs, pratios,
                          pbackground, structure, max_points,
                          allow_extrapolation=True):
    """Deterministic OI (oi.cpp:26-136). Grid or Points background."""
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background, "background")
    pobs = asarray_f32(pobs, "pobs").ravel()
    pratios = asarray_f32(pratios, "pratios").ravel()
    pbackground = asarray_f32(pbackground, "pbackground").ravel()
    _validate_oi(bgrid, background, points, pobs,
                 (pratios, pbackground), ("Ratios", "Background"))
    is_grid = isinstance(bgrid, Grid)
    bpoints = bgrid.to_points() if is_grid else bgrid
    flat_bg = background.ravel()
    ones = np.ones_like(flat_bg)
    out, _ = _oi_points(bpoints, flat_bg, ones, points, pobs, pratios,
                        pbackground, np.ones_like(pratios), structure,
                        max_points, allow_extrapolation, dev, host)
    return out.reshape(background.shape) if is_grid else out


def optimal_interpolation_full(bgrid, background, bvariance, points, obs,
                               obs_variance, background_at_points,
                               bvariance_at_points, structure, max_points,
                               allow_extrapolation=True):
    """Full OI with variances (oi.cpp:138-412).

    Returns (analysis, analysis_variance).
    """
    dev, host = api_device(), on_host()
    if max_points < 0:
        raise ValueError("max_points must be >= 0")
    background = asarray_f32(background, "background")
    bvariance = asarray_f32(bvariance, "bvariance")
    obs = asarray_f32(obs, "obs").ravel()
    obs_variance = asarray_f32(obs_variance, "obs_variance").ravel()
    background_at_points = asarray_f32(background_at_points,
                                       "background_at_points").ravel()
    bvariance_at_points = asarray_f32(bvariance_at_points,
                                      "bvariance_at_points").ravel()
    if background.shape != bvariance.shape:
        raise ValueError(
            f"Input bvariance ({bvariance.shape}) is not the same size as "
            f"the grid ({background.shape})")
    _validate_oi(bgrid, background, points, obs,
                 (obs_variance, background_at_points, bvariance_at_points),
                 ("Obs variance", "Background", "Background variance"))
    is_grid = isinstance(bgrid, Grid)
    bpoints = bgrid.to_points() if is_grid else bgrid
    out, avar = _oi_points(bpoints, background.ravel(), bvariance.ravel(),
                           points, obs, obs_variance, background_at_points,
                           bvariance_at_points, structure, max_points,
                           allow_extrapolation, dev, host)
    if is_grid:
        return out.reshape(background.shape), avar.reshape(background.shape)
    return out, avar
