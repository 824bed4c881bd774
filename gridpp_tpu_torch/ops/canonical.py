"""Canonical candidate selection: one host evaluation, shared by every path.

Round-4 finding: the serving pipelines and the host API each evaluated
the structure function with their own transcendental implementation
(TPU f32 `exp`, libm `expf`, numpy SIMD exp). At rho near-ties — two
observations metres apart in effective distance — those implementations
disagree in the last ulp, the top-`max_points` cut flips, and a
*different observation set* is selected, producing isolated
single-gridpoint divergences of up to ~1 K between paths that document
exact agreement.

Selection is a discrete decision, so the fix is to make its inputs
bit-identical everywhere: this module computes, once per
(grid, obs network, structure), a per-gridpoint candidate shortlist
whose order (rho descending, observation id ascending on exact ties)
and stored rho values come from a single HOST evaluation — the native
C++ pair kernel (csrc `pair_rho_host`, the same code the native OI
solvers run inside `select_topk`) when the structure maps to a native
kernel type, numpy otherwise. Serving pipelines consume it at
construction; accelerator API paths serve from it per call. The
discrete top-k decision then agrees exactly across host and device, and
parity divergence reduces to continuous solve numerics.

Selection semantics: reference oi.cpp:233-281 (radius query via rho > 0,
top-max_points by rho). The shortlist is built from a k-nearest-neighbour
proposal that is GROWN until provably complete: a row is complete when
its k-th neighbour lies beyond the localization radius, or when the
k_cap-th selected rho exceeds the maximum rho any farther observation
could reach (the distance-kernel factor at the k-th distance — valid for
every product structure because the vertical/laf factors are <= 1).
Structures with no such bound fall back to covering the full radius.
"""
from __future__ import annotations

import numpy as np

from ..structure import (CressmanStructure, CrossValidation,
                         LinearStructure, MultipleStructure, _KERNELS,
                         _KernelStructure, _NpWrap, StructureFunction)

__all__ = ["canonical_shortlist", "CanonicalShortlist", "monotone_obs"]


class CanonicalShortlist:
    """Per-gridpoint canonical candidate shortlist (host numpy arrays).

    sel:   (N, K) int32 observation ids, canonical order
    rho:   (N, K) float32 canonical selection rho (0 in invalid slots)
    valid: (N, K) bool
    truncated: (N,) bool — True where more than K in-range candidates
        exist (the shortlist is a strict top-K cut; consumers that must
        dig deeper than K valid entries need a fallback on these rows)
    """

    __slots__ = ("sel", "rho", "valid", "truncated", "k_cap", "n_obs")

    def __init__(self, sel, rho, valid, truncated, n_obs):
        self.sel = sel
        self.rho = rho
        self.valid = valid
        self.truncated = truncated
        self.k_cap = sel.shape[1]
        self.n_obs = n_obs


def _native_eval(structure):
    """(kernel_type, lib) when the native canonical evaluator applies."""
    from ..api.oi import _native_kernel_type
    from .. import native
    kt = _native_kernel_type(structure)
    if kt is None:
        return None
    if native.get_lib() is None:
        return None
    return kt


def _host_fields(pts, structure, origin, n):
    """f32 field dict x,y,z,elev,laf,h,v,w,loc — the exact arrays the
    native solvers receive (api/oi.py _oi_native), so canonical rho bits
    match the native in-kernel evaluation."""
    from ..api.oi import _resolved_fields, _with_scales
    fx = _with_scales(_resolved_fields(pts, structure, origin), structure,
                      n)
    fx["loc"] = np.asarray(structure.localization_np(pts.lats, pts.lons),
                           np.float32)
    return fx


def _np_rho(structure, gfx, ofx, rows, cand, mask):
    """numpy canonical rho for arbitrary structures (same field inputs
    as the native evaluator; numpy is the canonical implementation when
    no native kernel type applies)."""
    keys = ["x", "y", "z", "elev", "laf"]
    # h/v/w arrays only when resolve_p1_np produced them (spatial
    # structures); scalar structures read their own scale attributes, and
    # wrapper structures (Multiple/CrossValidation) would be poisoned by
    # the _with_scales fill values
    if getattr(structure, "is_spatial", False):
        keys += ["h", "v", "w"]
    p1 = {key: gfx[key][rows][:, None] for key in keys if key in gfx}
    p2 = {key: ofx[key][np.where(mask, cand, 0)]
          for key in ("x", "y", "z", "elev", "laf")}
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        rho = structure._corr_background(_NpWrap, np, p1, p2)
    rho = np.asarray(rho, np.float32)
    return np.where(mask, rho, 0.0).astype(np.float32)


def _dist_kernel(structure):
    """(kernel_fn, spatial) giving the horizontal-distance factor used
    for the completeness bound, or None when no bound exists."""
    s = structure
    while isinstance(s, CrossValidation):
        s = s.structure
    if isinstance(s, MultipleStructure):
        s = s.structure_h
    if isinstance(s, CressmanStructure):
        return _KERNELS["cressman"], False, s.h
    if isinstance(s, LinearStructure):
        # localization distance 0: any positive distance gives rho 0
        return (lambda xp, d, h: np.zeros_like(d)), False, 0.0
    if isinstance(s, _KernelStructure):
        if s.is_spatial:
            return _KERNELS[s.kernel_name], True, None
        return _KERNELS[s.kernel_name], False, s.h
    return None


def _rho_bound(structure, dist, h_rows):
    """Upper bound on canonical rho of any obs at distance >= dist, with
    a safety margin covering native-vs-numpy transcendental differences.
    Returns None when the structure admits no distance bound."""
    dk = _dist_kernel(structure)
    if dk is None:
        return None
    kernel, spatial, h = dk
    hv = h_rows if spatial else np.float32(h)
    with np.errstate(invalid="ignore", divide="ignore"):
        val = np.asarray(kernel(_NpWrap, dist.astype(np.float32), hv),
                         np.float32)
    return val * np.float32(1.0001) + np.float32(1e-6)


def monotone_obs(structure, opts) -> bool:
    """True when per-gridpoint rho order equals distance order.

    Holds for a plain kernel structure (incl. spatial h/v/w variants —
    their factors are per-GRIDPOINT constants) whose vertical and laf
    factors are constant across the OBSERVATION set: all obs elevations
    mutually equal or all missing, and likewise for lafs. Then the
    k-nearest proposal IS the top-k by rho, so the shortlist is
    complete at k_cap with no growth and no bound. Wrapper structures
    (Multiple, CrossValidation) and Linear (value-difference
    correlations) are excluded.
    """
    s = structure
    if not isinstance(s, _KernelStructure) or isinstance(
            s, LinearStructure):
        return False

    def const(a):
        a = np.asarray(a)
        f = np.isfinite(a)
        if not f.any():
            return True  # factor is uniformly skipped
        if not f.all():
            return False  # mixed skip/apply varies per obs
        return bool(np.all(a == a.ravel()[0]))

    return const(opts.elevs) and const(opts.lafs)


def _canonical_order(ids, rho, valid, n_obs):
    """Order: rho descending, obs id ascending on exact ties, invalid
    slots last. Returns take_along_axis index array.

    One argsort on a composite u64 key (valid rho is positive, so its
    f32 bit pattern is order-preserving; obs id breaks exact-bit ties).
    Keys are unique for valid slots, so sort stability is irrelevant."""
    rb = np.ascontiguousarray(rho, np.float32).view(np.uint32)
    key = ((np.uint64(0xFFFFFFFF) - rb.astype(np.uint64)) << np.uint64(32)
           | ids.astype(np.uint64))
    key = np.where(valid, key, np.uint64(0xFFFFFFFFFFFFFFFF))
    return np.argsort(key, axis=1)


def canonical_shortlist(bpoints, opts, structure: StructureFunction,
                        k_cap: int, block: int = 262144):
    """Build (and cache on `bpoints`) the canonical top-k_cap shortlist.

    bpoints: background Points (grid.to_points() or a Points set).
    opts: observation Points. Returns a CanonicalShortlist.
    """
    n = bpoints.size()
    n_obs = opts.size()
    k_cap = max(1, min(int(k_cap), n_obs))

    cache = bpoints.__dict__.setdefault("_canon_shortlist_cache", {})
    key = (n_obs, hash(opts.lats.tobytes()), hash(opts.lons.tobytes()),
           hash(opts.elevs.tobytes()), hash(opts.lafs.tobytes()),
           id(structure), k_cap)
    hit = cache.get(key)
    if hit is not None:
        return hit[0]

    from ..api.oi import _origin
    origin = _origin(bpoints)
    gfx = _host_fields(bpoints, structure, origin, n)
    ofx = _host_fields(opts, structure, origin, n_obs)
    kt = _native_eval(structure)

    def eval_rho(rows, cand, mask):
        if kt is not None:
            from .. import native
            gfb = {key2: v[rows] for key2, v in gfx.items()}
            out = native.pair_rho_host(gfb, ofx, cand, mask, kt)
            if out is not None:
                return out
        return _np_rho(structure, gfx, ofx, rows, cand, mask)

    loc = np.asarray(gfx["loc"], np.float64)
    rmax = float(loc.max()) if loc.size else 0.0
    ub = rmax if rmax > 0 else np.finfo(np.float64).tiny
    tree = opts.index.tree
    bxyz = bpoints.xyz
    mono = monotone_obs(structure, opts)

    sel = np.zeros((n, k_cap), np.int32)
    rho = np.zeros((n, k_cap), np.float32)
    valid = np.zeros((n, k_cap), bool)
    truncated = np.zeros(n, bool)

    for start in range(0, n, block):
        end = min(start + block, n)
        rows = np.arange(start, end)
        locb = loc[start:end]
        k = min(n_obs, k_cap + max(8, k_cap // 2))
        pending = rows
        while pending.size:
            dist, cand = tree.query(bxyz[pending], k=k,
                                    distance_upper_bound=ub, workers=-1)
            if k == 1:
                dist = dist[:, None]
                cand = cand[:, None]
            inrad = dist <= loc[pending][:, None]
            cand_m = np.where(inrad, cand, 0).astype(np.int32)
            rho_b = eval_rho(pending, cand_m, inrad)
            val_b = inrad & (rho_b > 0)
            order = _canonical_order(cand_m, rho_b, val_b,
                                     n_obs)[:, :k_cap]
            osel = np.take_along_axis(cand_m, order, axis=1)
            orho = np.take_along_axis(
                np.where(val_b, rho_b, 0.0), order, axis=1)
            oval = np.take_along_axis(val_b, order, axis=1)

            nvalid = val_b.sum(axis=1)
            # completeness: the proposal holds every in-range obs, or the
            # k_cap-th selected rho provably dominates anything farther
            covered = dist[:, -1] > loc[pending]
            if k >= n_obs:
                covered |= True
            need = ~covered
            bound_done = np.zeros(pending.size, bool)
            if need.any() and mono:
                # monotone order: a row holding k_cap valid candidates
                # already has the global top-k_cap (anything outside
                # the k-nearest proposal is farther, hence lower rho)
                idx = np.nonzero(need)[0]
                ok = nvalid[need] >= k_cap
                need[idx[ok]] = False
                bound_done[idx[ok]] = True
            if need.any():
                bound = _rho_bound(structure, dist[need, -1],
                                   gfx["h"][pending[need]]
                                   if "h" in gfx else None)
                if bound is not None:
                    full = oval[need, k_cap - 1]
                    ok = full & (orho[need, k_cap - 1] > bound)
                    idx = np.nonzero(need)[0]
                    need[idx[ok]] = False
                    bound_done[idx[ok]] = True
            done = ~need
            didx = pending[done]
            sel[didx] = osel[done]
            rho[didx] = orho[done]
            valid[didx] = oval[done]
            # bound-completed rows may hold in-range candidates BEYOND
            # the proposal; flag truncated conservatively so per-call
            # starved checks never miss a dig-deeper row
            truncated[didx] = (nvalid[done] > k_cap) | bound_done[done]
            pending = pending[need]
            if pending.size and k >= n_obs:
                # should be unreachable (k == n_obs always covers)
                break
            if pending.size:
                # Count-informed jump: when the rho bound cannot prove
                # completeness (strong vertical/laf kernels make the
                # k_cap-th selected rho tiny against the distance-only
                # bound), a blind x4 ladder burns full re-queries per
                # rung. One radius-count query (native cell-hash or
                # scipy return_length — no Python lists) sizes the
                # final proposal directly: k must EXCEED the in-radius
                # count so the k-th neighbour provably lies beyond the
                # localization radius. Counts use rmax (>= per-row
                # loc), an upper bound, so coverage stays provable.
                cts = opts.index.radius_counts(
                    bpoints.lats[pending], bpoints.lons[pending], ub)
                k_need = int(cts.max()) + 1 if cts.size else 4 * k
                k = min(n_obs, max(2 * k, k_need))
            else:
                k = min(n_obs, 4 * k)

    out = CanonicalShortlist(sel, rho, valid, truncated, n_obs)
    if len(cache) > 6:
        cache.clear()
    # pin the structure object so id() stays unique while cached
    cache[key] = (out, structure)
    return out
