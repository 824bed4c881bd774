"""Ensemble OI (EnSI, the local ensemble transform) on tensors
(gridpp_tpu/ops/oi_ensi.py, oi_ensi.cpp:114-568).

Per gridpoint: Pinv = Y^T Rinv Y + (E-1) I from the selected obs' member
anomalies, its inverse square root by a coupled Newton-Schulz iteration,
and the member increments (W x)_e + x . w with W = sqrt((E-1) Pinv^-1) and
w = Pinv^-1 C innov. Rows are batch-first: (B, S) selections, (B, S, E)
anomalies, (B, E, E) matrices, and every E x E product is one batched f32
`torch.matmul` (see `_mm`).

Padding trick: invalid or padded obs slots get Rinv = 0 and zero
innovation, which leaves C = Y^T Rinv, Pinv and w exactly as if the slot
were absent.

Three sweeps, plain functions on tensors: `ensi_kernel` (host-fed
candidates, the structure evaluated here), `ensi_shortlist_sweep` (the
canonical shortlist re-selected with this call's obs validity) and
`ensi_dense_sweep` (rho against every observation).

The sweeps' per-gridpoint update is one hand-written kernel on the card,
csrc/ensi_transform.cu (`ensi_update_cuda`), wherever `kernel_takes` the
block by its shapes: f32 on a CUDA device with E and S at most 32. Beside
it sits its plain version, `ensi_update_plain` (the chain of batched
products above), which the CPU and every other shape run. `ensi_kernel`
and the ensi_multi family keep the chain.
"""
from __future__ import annotations

import ctypes

import torch

from ..tracing import count
from .oi import _blocks, _select_top
from .stencil import _launcher

__all__ = ["obs_anomalies", "ensi_kernel", "ensi_shortlist_sweep",
           "ensi_dense_sweep", "ensi_update_cuda", "ensi_update_plain",
           "kernel_takes", "KERNEL_MAX_E", "KERNEL_MAX_S"]

# Minimax-optimal odd-polynomial schedule for the coupled Newton-Schulz
# inverse-sqrt iteration (computed offline via per-step LP on the current
# singular-value interval, Polar-Express style). Applied as
# sigma <- a*sigma + b*sigma^3 + c*sigma^5, the composition maps every
# sigma in [2e-4, 1] to within 2e-5 of 1 (float32-verified); the two
# trailing (1.5, -0.5, 0) entries are plain Newton-Schulz steps whose
# quadratic convergence pushes the error to the float32 roundoff floor.
_NS_COEFFS = (
    (8.501080, -25.229504, 18.725874),
    (4.234522, -3.144556, 0.584696),
    (4.162825, -3.094790, 0.579020),
    (3.889070, -2.902615, 0.557114),
    (3.115613, -2.335580, 0.492763),
    (2.150920, -1.530978, 0.404032),
    (1.880115, -1.255672, 0.375568),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
    (1.5, -0.5, 0.0),
)


def _tf32_matmul() -> bool:
    """Whether cuBLAS may run f32 products in TF32 in this process."""
    mm = torch.backends.cuda.matmul
    prec = getattr(mm, "fp32_precision", None)
    if prec is None:  # torch without the fp32_precision settings
        return bool(mm.allow_tf32)
    if prec == "none":
        prec = torch.backends.fp32_precision
    return prec == "tf32"


def _mm(u, v):
    """Batched f32 matrix product (B, m, k) @ (B, k, n).

    Never in TF32: rounded operands make the Pinv product asymmetric and
    Newton-Schulz diverges on asymmetric input (gridpp_tpu saw ~0.01% of
    gridpoints blow up to ~1e23 with reduced-precision products,
    ops/oi_ensi.py:133-140). On the card this raises rather than run with
    TF32 switched on."""
    if u.is_cuda and _tf32_matmul():
        raise RuntimeError(
            "ensemble OI needs full f32 matrix products; TF32 is on for "
            "cuBLAS (torch.backends.cuda.matmul)")
    return torch.matmul(u, v)


def _mv(z, x):
    """(B, m, k) matrix times per-row vector (B, k) -> (B, m)."""
    return _mm(z, x[:, :, None])[:, :, 0]


def _sym(a):
    return 0.5 * (a + a.transpose(1, 2))


def _inv_sqrt_ns(pinv):
    """Batched SPD inverse square root via coupled Newton-Schulz.

    pinv: (B, E, E) with lambda_min >= E-1 by construction (Pinv = Y^T
    Rinv Y + (E-1) I, oi_ensi.cpp:377-390). Returns (z (B, E, E), c (B,))
    with pinv^{-1/2} = z / sqrt(c) and pinv^{-1} = z z / c. The coupled
    (Y, Z) form is used because the Z-only variant (T = Z A Z) is
    numerically unstable (Higham, Functions of Matrices, ch. 6).
    gridpp_tpu's `_inv_sqrt_ns_m` is the same iteration in its TPU's
    batch-minor (E, E, B) layout."""
    e = pinv.shape[-1]
    # inf-norm upper bound on lambda_max for normalization
    c = torch.abs(pinv).sum(dim=2).amax(dim=1)
    c = torch.where(torch.isfinite(c) & (c > 0), c, 1.0)
    # the iteration diverges on non-symmetric input; enforce symmetry
    a_mat = _sym(pinv / c[:, None, None])
    eye = torch.eye(e, dtype=pinv.dtype, device=pinv.device)
    y = a_mat
    last = len(_NS_COEFFS) - 1
    for i, (ca, cb, cc) in enumerate(_NS_COEFFS):
        t = a_mat if i == 0 else _sym(_mm(z, y))  # z = I, y = A at step 0
        q = ca * eye + cb * t
        if cc:
            q = q + cc * _mm(t, t)
        if i != last:  # y is not needed after the final z update
            y = _mm(y, q)
        z = q if i == 0 else _mm(q, z)  # q @ I is q exactly
    return _sym(z), c


def _transform(l_y, rinv, innov, ridge: float):
    """Pinv = Y^T Rinv Y + ridge I, its Newton-Schulz inverse square root
    and w = Pinv^-1 C innov (oi_ensi.cpp:296-421). l_y: (B, S, E);
    rinv, innov: (B, S), 0 on padded slots. Returns (z, c_norm, w,
    cond_ok)."""
    e = l_y.shape[2]
    c_mat = l_y.transpose(1, 2) * rinv[:, None, :]  # (B, E, S) = Y^T Rinv
    pinv = _sym(_mm(c_mat, l_y)) \
        + ridge * torch.eye(e, dtype=torch.float32, device=l_y.device)
    # Pinv is SPD by construction, so the reference's `rcond <= 0`
    # fallback (oi_ensi.cpp:386-390) can only trigger on non-finite
    # input; mirror it with a finiteness guard, counted the same way
    # (oi_ensi.cpp:557-566).
    z, c_norm = _inv_sqrt_ns(pinv)
    cond_ok = torch.isfinite(pinv).all(dim=(1, 2)) \
        & torch.isfinite(z).all(dim=(1, 2))
    cv = _mv(c_mat, innov)
    w_vec = _mv(z, _mv(z, cv)) / c_norm[:, None]
    # One step of iterative refinement against Pinv itself. z z / c carries
    # the iteration's ~1e-5 relative error, and where C innov is large
    # against w = Pinv^-1 C innov, w = z z C innov / c (gridpp_tpu's form)
    # keeps only ~3 digits in f32: on the benchmark's 256 x 256 cut its
    # x . w term was 4.3e-3 K off float64, 2e-5 K after this step
    # (ROADMAP F6).
    w_vec = w_vec + _mv(z, _mv(z, cv - _mv(pinv, w_vec))) / c_norm[:, None]
    return z, c_norm, w_vec, cond_ok


def _finish(increment, x, ens_mean, background, sel_valid, l_obs, l_yhat,
            l_y, cond_ok, allow_extrapolation: bool):
    """The no-extrapolation clamp and the ok guard shared by EnSI and utem.
    Returns (analysis (B, E), cond_bad (B,)); rows without a valid obs, a
    finite transform or a finite analysis keep their background."""
    b, s, e = l_y.shape
    if not allow_extrapolation:
        # Reference quirk (oi_ensi.cpp:520-537): lY[e] is the e-th element
        # of the column-major flattened Y matrix - with the ACTUAL
        # per-gridpoint selection count as the row stride, so the member
        # index decomposes as (obs e % cnt, member e // cnt).
        cntv = torch.clamp(sel_valid.sum(dim=1), min=1)
        e_idx = torch.arange(e, device=l_y.device)
        obs_i = e_idx[None, :] % cntv[:, None]
        mem_j = e_idx[None, :] // cntv[:, None]
        y_elem = torch.gather(l_y.reshape(b, s * e), 1, obs_i * e + mem_j)
        diff = torch.where(sel_valid[:, :, None],
                           (l_obs - l_yhat)[:, :, None]
                           - y_elem[:, None, :], torch.nan)
        max_inc = torch.amax(torch.where(torch.isnan(diff), -torch.inf,
                                         diff), dim=1)
        min_inc = torch.amin(torch.where(torch.isnan(diff), torch.inf,
                                         diff), dim=1)
        member_inc = increment - x
        c1 = (max_inc > 0) & (member_inc > max_inc)
        c2 = ~c1 & (max_inc < 0) & (member_inc > 0)
        c3 = ~c1 & ~c2 & (min_inc < 0) & (member_inc < min_inc)
        c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (member_inc < 0)
        increment = torch.where(
            c1, max_inc + x,
            torch.where(c2, x, torch.where(c3, min_inc + x,
                                           torch.where(c4, x, increment))))
    analysis = ens_mean[:, None] + increment
    any_valid = sel_valid.any(dim=1)
    cond_bad = any_valid & ~cond_ok
    ok = any_valid & cond_ok & torch.isfinite(analysis).all(dim=1)
    return torch.where(ok[:, None], analysis, background), cond_bad


def _ensi_update(sel_valid, l_rho, l_obs, l_sig, l_y, l_yhat, background,
                 allow_extrapolation: bool):
    """Shared EnSI tail after selection (oi_ensi.cpp:296-553).

    sel_valid/l_rho/l_obs/l_sig/l_yhat: (B, S); l_y: (B, S, E) anomalies;
    background: (B, E) valid members. Returns (analysis (B, E),
    cond_bad (B,))."""
    e = background.shape[1]
    # Rinv diagonal: rho / sigma^2 (oi_ensi.cpp:296-302); zero for padded
    rinv = torch.where(sel_valid, l_rho / (l_sig * l_sig), 0.0)
    innov = torch.where(sel_valid, l_obs - l_yhat, 0.0)
    z, c_norm, w_vec, cond_ok = _transform(l_y, rinv, innov, float(e - 1))
    # increment_e = sum_k x_k (W + w 1^T)(k,e) = (W x)_e + (x . w), with
    # W = sqrt((E-1)/c) z symmetric - the full (B, E, E) W of the
    # reference (oi_ensi.cpp:429-444) is never materialized.
    ens_mean = torch.mean(background, dim=1)
    x = background - ens_mean[:, None]
    increment = torch.sqrt((e - 1) / c_norm)[:, None] * _mv(z, x) \
        + torch.sum(x * w_vec, dim=1, keepdim=True)
    return _finish(increment, x, ens_mean, background, sel_valid, l_obs,
                   l_yhat, l_y, cond_ok, allow_extrapolation)


def ensi_update_plain(g, rho, valid, tab, background,
                      allow_extrapolation: bool):
    """The kernel's function in plain PyTorch: the block's rows of the
    packed per-obs table tab (P, 3 + E) gathered by g (B, S), then
    `_ensi_update`. rho is read on valid slots alone. Returns (analysis
    (B, E), cond_bad (B,))."""
    f = tab[g]  # (B, S, 3 + E)
    return _ensi_update(valid, rho, f[:, :, 0], f[:, :, 1], f[:, :, 3:],
                        f[:, :, 2], background, allow_extrapolation)


# the members and selected obs a row that csrc/ensi_transform.cu takes
KERNEL_MAX_E = KERNEL_MAX_S = 32
# the Newton-Schulz schedule as the kernel reads it: (a, b, c) a step
_NS_FLAT = (ctypes.c_float * (3 * len(_NS_COEFFS)))(
    *(v for step in _NS_COEFFS for v in step))


def kernel_takes(device, dtype, e: int, s: int) -> bool:
    """Whether a block of E members and S selected obs goes through the
    kernel: f32 on a CUDA device, 1 <= E <= KERNEL_MAX_E and 1 <= S <=
    KERNEL_MAX_S. Chosen by shape; the chain takes every other block."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and 1 <= e <= KERNEL_MAX_E and 1 <= s <= KERNEL_MAX_S)


def _check_kernel_args(g, rho, valid, tab, background, out, cond_bad):
    if g.dtype != torch.int64:
        raise TypeError(f"g must be int64, got {g.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    for name, t in (("rho", rho), ("tab", tab), ("background", background),
                    ("out", out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if cond_bad is not None and cond_bad.dtype != torch.bool:
        raise TypeError(f"cond_bad must be bool, got {cond_bad.dtype}")
    if g.dim() != 2 or background.dim() != 2 or tab.dim() != 2:
        raise ValueError("expected g (B, S), background (B, E) and tab "
                         "(P, 3 + E)")
    b, s = g.shape
    e = background.shape[1]
    shapes = (("rho", rho, (b, s)), ("valid", valid, (b, s)),
              ("background", background, (b, e)),
              ("tab", tab, (tab.shape[0], 3 + e)), ("out", out, (b, e)),
              ("cond_bad", cond_bad, (b,)))
    for name, t, want in shapes:
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if not (1 <= e <= KERNEL_MAX_E and 1 <= s <= KERNEL_MAX_S):
        raise ValueError(f"the kernel takes 1 to {KERNEL_MAX_E} members and "
                         f"1 to {KERNEL_MAX_S} selected obs, got E={e}, "
                         f"S={s}")
    tensors = [t for t in (g, rho, valid, tab, background, out, cond_bad)
               if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ensi_update_cuda needs contiguous tensors")
    if not all(t.is_cuda and t.device == background.device
               for t in tensors):
        raise ValueError("ensi_update_cuda needs CUDA tensors on one device")


def ensi_update_cuda(g, rho, valid, tab, background,
                     allow_extrapolation: bool, out=None, cond_bad=None):
    """`ensi_update_plain` in one launch of csrc/ensi_transform.cu, on
    contiguous CUDA tensors: g (B, S) int64, rho (B, S) f32, valid (B, S)
    bool, tab (P, 3 + E) f32, background (B, E) f32, with 1 <= E, S <= 32.
    out (B, E) f32 and cond_bad (B,) bool, when given, are written in
    place. Returns (analysis, cond_bad). Counts its calls in
    `ensi_update_cuda.launches` and in the tracing session's
    `kernel.ensi_update`."""
    _check_kernel_args(g, rho, valid, tab, background, out, cond_bad)
    dev = background.device
    if out is None:
        out = torch.empty_like(background)
    if cond_bad is None:
        cond_bad = torch.empty(g.shape[0], dtype=torch.bool, device=dev)
    err = _launcher("ensi_transform")(
        g.data_ptr(), rho.data_ptr(), valid.data_ptr(), tab.data_ptr(),
        background.data_ptr(), out.data_ptr(), cond_bad.data_ptr(),
        g.shape[0], tab.shape[0], g.shape[1], background.shape[1],
        int(bool(allow_extrapolation)), _NS_FLAT, len(_NS_COEFFS),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ensi_transform kernel launch failed: error "
                           f"{err}")
    ensi_update_cuda.launches += 1
    count("kernel.ensi_update")
    return out, cond_bad


ensi_update_cuda.launches = 0


def _s_cap(max_points: int, k: int) -> int:
    return min(max_points, k) if max_points > 0 else k


def _reselect(sel, rho, valid, obs_ok, s_cap: int):
    """The top s_cap shortlist candidates whose obs are valid this cycle.

    sel/rho/valid: (B, K) shortlist rows; obs_ok: (P,) bool. Returns
    (sel_valid (B, S), l_rho (B, S), obs index g (B, S))."""
    sel = sel.long()
    vals, sub, sel_valid = _select_top(rho, valid & obs_ok[sel], s_cap)
    return sel_valid, torch.where(sel_valid, vals, 0.0), \
        torch.gather(sel, 1, sub)


def _sweep(background, tab, select, block: int, allow_extrapolation: bool):
    """EnSI over the rows of background (N, E), `block` rows at a time.

    select(rows) gives the rows' selection (sel_valid, l_rho, obs index
    g), each (B, S), l_rho read on valid slots alone; tab: (P, 3 + E)
    packed per-obs table [obs, sigma, y_hat, y_anom...]. A block that
    `kernel_takes` is one launch of the kernel, which gathers the table
    rows itself and writes into the result; any other block runs the
    plain version, one gather per block for all the table's columns.
    Returns (analysis (N, E), cond_bad (N,))."""
    n, e = background.shape
    dev = background.device
    out = torch.empty((n, e), dtype=background.dtype, device=dev)
    cond_bad = torch.empty(n, dtype=torch.bool, device=dev)
    for rows in _blocks(n, block):
        sel_valid, l_rho, g = select(rows)
        if kernel_takes(dev, background.dtype, e, g.shape[1]):
            ensi_update_cuda(g.contiguous(), l_rho.contiguous(),
                             sel_valid.contiguous(), tab,
                             background[rows].contiguous(),
                             allow_extrapolation, out[rows], cond_bad[rows])
        else:
            out[rows], cond_bad[rows] = ensi_update_plain(
                g, l_rho, sel_valid, tab, background[rows],
                allow_extrapolation)
    return out, cond_bad


def _shortlist_sweep(cand, background, tab, obs_ok, s_cap: int, block: int,
                     allow_extrapolation: bool, prefix: bool = False):
    """EnSI over the grid from a shortlist cand = (sel, rho, valid), each
    (N, K): candidates whose obs are invalid (obs_ok (P,)) are masked and
    the top s_cap re-selected. With `prefix`, every obs is valid and cand
    holds the shortlist's first s_cap slots, which are then the
    selection."""
    sel, rho, valid = cand

    def select(rows):
        if prefix:  # views: the update reads rho on valid slots alone
            return valid[rows], rho[rows], sel[rows]
        return _reselect(sel[rows], rho[rows], valid[rows], obs_ok, s_cap)

    return _sweep(background, tab, select, block, allow_extrapolation)


def obs_anomalies(pback):
    """The ensemble mean at each obs point over its finite members, NaN
    where none is finite, and the members' anomalies from it (member kept
    as it is where it or the mean is not finite; oi_ensi.cpp:166-178).
    pback: (P, E). Returns (y_hat (P,), y_anom (P, E))."""
    fin = torch.isfinite(pback)
    cnt = fin.sum(dim=1)
    y_hat = torch.where(
        cnt > 0, torch.where(fin, pback, 0.0).sum(dim=1)
        / torch.clamp(cnt, min=1), torch.nan)
    y_anom = torch.where(fin & torch.isfinite(y_hat)[:, None],
                         pback - y_hat[:, None], pback)
    return y_hat, y_anom


def _table(obs, sigmas, y_hat, y_anom):
    return torch.cat([obs[:, None], sigmas[:, None], y_hat[:, None],
                      y_anom], dim=1)


def ensi_kernel(structure, p1_fields, cand_fields, cand_valid, background,
                obs, sigmas, y_anom, y_hat, max_points: int,
                allow_extrapolation: bool):
    """EnSI from host-fed candidates (gridpp_tpu make_ensi_kernel).

    p1_fields: dict of (B, 1) gridpoint fields; cand_fields: dict of (B, K)
    candidate obs fields; cand_valid: (B, K); background: (B, E) valid
    members; obs/sigmas/y_hat: (B, K) gathered; y_anom: (B, K, E)
    anomalies at the candidates. Returns (analysis, cond_bad)."""
    s_cap = _s_cap(max_points, obs.shape[1])
    rho = structure.corr_background_torch(p1_fields, cand_fields)
    vals, sel, sel_valid = _select_top(rho, cand_valid & (rho > 0), s_cap)
    l_rho = torch.where(sel_valid, vals, 0.0).to(torch.float32)
    return _ensi_update(
        sel_valid, l_rho, torch.gather(obs, 1, sel),
        torch.gather(sigmas, 1, sel),
        torch.take_along_dim(y_anom, sel[:, :, None], dim=1),
        torch.gather(y_hat, 1, sel), background, allow_extrapolation)


def ensi_shortlist_sweep(sel, rho, valid, background, obs, sigmas, y_anom,
                         y_hat, max_points: int, allow_extrapolation: bool,
                         block: int):
    """Whole-grid EnSI from a canonical candidate shortlist (gridpp_tpu
    make_ensi_shortlist_sweep): candidates with invalid obs are masked and
    the top max_points re-selected among the survivors. The caller is
    responsible for the starved-row fallback (rows whose truncated
    shortlist keeps fewer than max_points valid candidates).

    sel/rho/valid: (N, K); background: (N, E); obs/sigmas/y_hat: (P,);
    y_anom: (P, E). Returns (analysis (N, E), cond_bad (N,))."""
    return _shortlist_sweep(
        (sel, rho, valid), background, _table(obs, sigmas, y_hat, y_anom),
        torch.isfinite(obs), _s_cap(max_points, sel.shape[1]), block,
        allow_extrapolation)


def ensi_dense_sweep(structure, p1_fields, obs_fields, background, obs,
                     sigmas, y_anom, y_hat, max_points: int,
                     allow_extrapolation: bool, block: int):
    """Whole-grid EnSI with rho against every observation and the top-k
    selection here (gridpp_tpu make_ensi_dense_sweep).

    p1_fields: dict of (N,); obs_fields: dict of (P,); background: (N, E);
    obs/sigmas/y_hat: (P,); y_anom: (P, E). Returns (analysis (N, E),
    cond_bad (N,))."""
    s_cap = _s_cap(max_points, obs.shape[0])
    o2 = {key: v[None, :] for key, v in obs_fields.items()}

    def select(rows):
        p1 = {key: v[rows, None] for key, v in p1_fields.items()}
        rho = structure.corr_background_torch(p1, o2)  # (B, P)
        vals, sel, sel_valid = _select_top(rho, rho > 0, s_cap)
        return sel_valid, torch.where(sel_valid, vals, 0.0).to(
            torch.float32), sel

    return _sweep(background, _table(obs, sigmas, y_hat, y_anom), select,
                  block, allow_extrapolation)
