"""Operational OI calibrator (reference src/client/Calibrator/Oi.cpp).

The reference's 1218-line calibrator is MET Norway's production
analysis step: ensemble-mode ETKF (or single-member kriging) against
point observations from a parameter file, with Box-Cox transforms,
persistent bias/delta state variables, cross-validation, elevation
gradients, land/elevation station screening and radar (spatially
correlated) observation errors.

This implementation is a vectorized redesign: station screening and the
per-gridpoint candidate selection are batched numpy over the whole
grid, and the local updates (E x E ETKF or S x S kriging) run as
batched linear algebra over all gridpoints at once instead of the
reference's per-gridpoint Armadillo loop (Oi.cpp:441-1010).

Deviations from the reference, chosen deliberately:
- candidate gathering uses an exact radius query (radius
  sqrt(-2 ln minRho) * d) instead of the reference's square gridpoint-
  box approximation (Oi.cpp:188-191 calls its own spreading "only meant
  to be an approximation"); the subsequent rho > minRho filter is
  identical.
- distances are chord distances (the library's geometry) rather than
  great-circle arcs; the relative difference is < 1e-4 at 100 km.
- numParameters == 1 is served with Ci = 1 in ensemble mode where the
  reference calls abort() (Oi.cpp:766).
"""
from __future__ import annotations

import math

import numpy as np

import gridpp_tpu_torch as gridpp
from ..api import neighbourhood as nbh


def _isvalid_f(v) -> bool:
    """Reference Util::isValid: not NaN/inf and not the -999 sentinel
    (Util.h:42-44, Util::MV = -999)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return False
    return math.isfinite(v) and v != -999.0


class CalibratorOi:
    """-c oi: merge observations with the background via OI."""

    def __init__(self, variable, options):
        self.variable = variable
        self.options = options
        o = options
        # names follow the reference CLI: d = horizontal scale,
        # h = vertical scale, w = laf scale (Oi.cpp:49-86)
        self.hlength = o.get("d", 30000.0, float)
        self.vlength = o.get("h", 100.0, float)
        self.wlength = o.get("w", 0.2, float)
        self.hlength_c = o.get("dc", 10000.0, float)
        self.mu = o.get("mu", 0.9, float)
        self.gamma = o.get("gamma", 0.25, float)
        self.min_rho = o.get("minRho", 0.0013, float)
        self.epsilon = o.get("epsilon", 0.5, float)
        # faithful to Oi.cpp:74-76: when epsilonC IS given it is
        # overwritten with epsilon (a reference quirk), else 0.5
        self.epsilon_c = (self.epsilon if o.get("epsilonC") is not None
                          else 0.5)
        self.sigma = o.get("sigma", 1.0, float)
        self.sigma_c = o.get("sigmaC", self.sigma, float)
        self.delta = o.get("delta", 1.0, float)
        self.c = o.get("c", 1.03, float)
        self.new_delta_var = o.get("newDeltaVar", 1.0, float)
        self.bias_variable = o.get("biasVariable", "")
        self.delta_variable = o.get("deltaVariable", "")
        self.num_variable = o.get("numVariable", "")
        self.elev_gradient = o.get("elevGradient", -999.0, float)
        self.max_locations = o.get("maxLocations", 20, int)
        self.max_elev_diff = o.get("maxElevDiff", 200.0, float)
        self.min_valid_ens = o.get("minEns", 5, int)
        self.use_ens = o.get("useEns", True, bool)
        self.extrapolate = o.get("extrapolate", False, bool)
        self.diagnose = o.get("diagnose", False, bool)
        self.save_diff = o.get("saveDiff", False, bool)
        self.cross_validate = o.get("crossValidate", False, bool)
        self.land_only = o.get("landOnly", False, bool)
        self.wmin = o.get("wmin", -999.0, float)
        self.lambda_ = o.get("lambda", 0.5, float)
        self.box_cox_threshold = o.get("boxCoxThreshold", -999.0, float)
        self.max_bytes = o.get("maxBytes", 6.0 * 1024 ** 3, float)
        self.dia_file = o.get("diaFile", "")
        transform = o.get("transform", "none")
        if transform not in ("none", "boxcox"):
            raise RuntimeError(
                f"Could not recognize transform={transform}")
        self.transform_type = transform
        rho_type = o.get("rhoType", "gaussian")
        if rho_type not in ("gaussian", "soar"):
            raise RuntimeError(f"Could not recognize rhoType={rho_type}")
        self.rho_type = rho_type

    # ---- transforms (Oi.cpp:1149-1177) ---------------------------------
    def _transform(self, v):
        if self.transform_type == "none":
            return v
        v = np.maximum(np.asarray(v, np.float64), 0.0)
        if self.lambda_ == 0:
            with np.errstate(divide="ignore"):
                return np.log(v)
        return (np.power(v, self.lambda_) - 1) / self.lambda_

    def _inv_transform(self, v):
        if self.transform_type == "none":
            return v
        v = np.asarray(v, np.float64)
        if self.lambda_ == 0:
            out = np.exp(v)
        else:
            v = np.maximum(v, -1.0 / self.lambda_)
            out = np.power(1 + self.lambda_ * v, 1 / self.lambda_)
        return np.maximum(out, 0.0)

    # ---- rho (Oi.cpp:1123-1147) ----------------------------------------
    def _calc_rho(self, hdist, vdist, lafdist):
        """Vectorized calcRho: horizontal gaussian/soar x vertical
        gaussian x laf (linear wmin and/or gaussian wLength) factors.
        A missing vertical distance (NaN) zeroes rho when the vertical
        scale is enabled."""
        h = hdist / self.hlength
        if self.rho_type == "gaussian":
            rho = np.exp(-0.5 * h * h)
        else:
            rho = (1 + h) * np.exp(-h)
        if _isvalid_f(self.vlength):
            with np.errstate(invalid="ignore"):
                v = vdist / self.vlength
                vfac = np.exp(-0.5 * v * v)
            rho = np.where(np.isfinite(vdist), rho * vfac, 0.0)
        if _isvalid_f(self.wmin):
            rho = rho * (1 - (1 - self.wmin) * np.abs(lafdist))
        if _isvalid_f(self.wlength):
            rho = rho * np.exp(
                -0.5 * lafdist * lafdist / (self.wlength ** 2))
        return rho

    # ---- main ----------------------------------------------------------
    def calibrate(self, ofile, parameter_file=None):
        if parameter_file is None:
            raise RuntimeError("-c oi requires a parameter file")
        grid = ofile.grid
        lats = np.asarray(grid.lats, np.float64)
        lons = np.asarray(grid.lons, np.float64)
        elevs = np.asarray(grid.elevs, np.float64)
        lafs = np.asarray(grid.lafs, np.float64)
        ny, nx = lats.shape
        if not (np.isfinite(lats) & np.isfinite(lons)
                & np.isfinite(elevs)).any():
            import warnings
            warnings.warn("There are no gridpoints with valid "
                          "lat/lon/elev values. Skipping oi...")
            return

        points, params = parameter_file.to_points()
        g_s = points.size()
        params = np.asarray(params, np.float64)
        if params.ndim == 1:
            params = params[:, None]
        num_parameters = params.shape[1]
        if num_parameters > 3:
            raise RuntimeError(
                f"Parameter file has {num_parameters} parameters, which "
                "is greater than 3")

        g_obs = np.where(np.isfinite(params[:, 0]),
                         self._transform(params[:, 0]), np.nan)
        g_ci = (params[:, 1] if num_parameters >= 2
                else np.ones(g_s)).astype(np.float64)
        g_radarl = (params[:, 2] if num_parameters >= 3
                    else np.zeros(g_s)).astype(np.float64)

        st_lats = np.asarray(points.lats, np.float64)
        st_lons = np.asarray(points.lons, np.float64)
        st_elevs = np.asarray(points.elevs, np.float64)

        # nearest gridpoint per station
        flat_nn = grid.nearest_map(st_lats, st_lons)
        yi, xi = np.unravel_index(flat_nn, (ny, nx))
        g_lafs = lafs[yi, xi]
        nn_elevs = elevs[yi, xi]

        # grid regularity (Oi.cpp:168-181)
        regular = ny > 1 and nx > 1
        if regular:
            grid_size = float(np.asarray(gridpp.KDTree.calc_distance(
                lats[0, 0], lons[0, 0], lats[1, 0], lons[1, 0])))
            radius_factor = math.sqrt(-2 * math.log(self.min_rho))
            gridpoint_radius = radius_factor * self.hlength / max(
                grid_size, 1e-9)
            expected = gridpoint_radius ** 2 * 4 * 4 * g_s
            if _isvalid_f(self.max_bytes) and expected > self.max_bytes:
                raise RuntimeError(
                    f"Number of required bytes ({expected / 1024 / 1024} "
                    f"MB) exceeds threshold "
                    f"{self.max_bytes / 1024 / 1024} MB. Use maxBytes= "
                    "to set threshold.")

        # ---- station screening (Oi.cpp:237-310) ------------------------
        inside = np.ones(g_s, bool)
        if regular:
            inside = ((xi > 0) & (xi < nx - 1)
                      & (yi > 0) & (yi < ny - 1))
        obs_ok = np.isfinite(g_obs)
        if _isvalid_f(self.max_elev_diff):
            has_elev = np.isfinite(st_elevs) & (st_elevs != -999.0)
            elev_ok = has_elev & (
                np.abs(np.where(has_elev, st_elevs, 0.0) - nn_elevs)
                < self.max_elev_diff)
        else:
            elev_ok = np.ones(g_s, bool)
        laf_ok = ~(np.isfinite(g_lafs) & self.land_only & (g_lafs == 0))
        keep = inside & obs_ok & elev_ok & laf_ok

        if self.dia_file:
            with open(self.dia_file, "w") as fh:
                for i in range(g_s):
                    if inside[i] and obs_ok[i]:
                        if not elev_ok[i]:
                            fh.write(f"{st_lons[i]};{st_lats[i]};1;\n")
                        elif not laf_ok[i]:
                            fh.write(f"{st_lons[i]};{st_lats[i]};2;\n")

        kidx = np.nonzero(keep)[0]
        field_all = ofile.get_field(self.variable)
        nt = field_all.shape[0]
        n_ens = field_all.shape[3]
        out_all = field_all.copy()

        if kidx.size == 0:
            return

        # ---- per-gridpoint candidates + rho (once; geometry is static) -
        elev_k = np.where(np.isfinite(st_elevs[kidx])
                          & (st_elevs[kidx] != -999.0),
                          st_elevs[kidx], np.nan)
        opts = gridpp.Points(st_lats[kidx], st_lons[kidx], elev_k)
        radius_factor = math.sqrt(-2 * math.log(self.min_rho))
        radius = radius_factor * self.hlength
        bpoints = grid.to_points()
        lists = opts.index.tree.query_ball_point(bpoints.xyz, r=radius,
                                                 workers=-1)
        counts = np.fromiter((len(lst) for lst in lists), np.int64,
                             count=len(lists))
        smax = int(counts.max()) if counts.size else 0
        n = ny * nx
        if smax == 0:
            return
        cand = np.zeros((n, smax), np.int64)
        cmask = np.zeros((n, smax), bool)
        for i, lst in enumerate(lists):
            c = len(lst)
            if c:
                cand[i, :c] = lst
                cmask[i, :c] = True

        # rho per (gridpoint, candidate)
        gxyz = bpoints.xyz
        oxyz = opts.xyz
        d2 = np.zeros((n, smax))
        for a in range(3):
            d2 += (gxyz[:, a][:, None] - oxyz[cand, a]) ** 2
        hdist = np.sqrt(d2)
        vdist = elev_k[cand] - elevs.reshape(-1)[:, None]
        st_laf_k = g_lafs[kidx]
        both_laf = (np.isfinite(st_laf_k[cand])
                    & np.isfinite(lafs.reshape(-1))[:, None])
        lafdist = np.where(both_laf,
                           st_laf_k[cand] - lafs.reshape(-1)[:, None],
                           0.0)
        with np.errstate(invalid="ignore"):
            rho = self._calc_rho(hdist, vdist, lafdist)
        cmask &= np.nan_to_num(rho, nan=0.0) > self.min_rho
        rho = np.where(cmask, rho, 0.0)

        # cross-validation: drop the single best-rho candidate per
        # gridpoint (Oi.cpp:477-499)
        if self.cross_validate:
            best = np.argmax(np.where(cmask, rho, 0.0), axis=1)
            has_any = cmask.any(axis=1)
            cmask[np.arange(n)[has_any], best[has_any]] = False
            rho = np.where(cmask, rho, 0.0)

        # keep the top maxLocations by rho (Oi.cpp:500-522)
        s_cap = min(self.max_locations, smax)
        order = np.argsort(-np.where(cmask, rho, -np.inf),
                           axis=1, kind="stable")[:, :s_cap]
        l_idx = np.take_along_axis(cand, order, axis=1)
        l_rho = np.take_along_axis(rho, order, axis=1)
        l_mask = np.take_along_axis(cmask, order, axis=1)
        l_obs = np.where(l_mask, g_obs[kidx][l_idx], 0.0)
        l_ci = np.where(l_mask, g_ci[kidx][l_idx], 1.0)
        l_radar = np.where(l_mask, g_radarl[kidx][l_idx], 0.0)
        l_s = l_mask.sum(axis=1)
        has_obs = l_s > 0

        use_bias = self.bias_variable != ""
        use_delta = self.delta_variable != ""

        newbias_all = (np.zeros((nt, ny, nx, n_ens), np.float32)
                       if use_bias else None)
        newdelta_all = (np.zeros((nt, ny, nx, n_ens), np.float32)
                        if use_delta else None)
        num_all = (np.zeros((nt, ny, nx, n_ens), np.float32)
                   if self.num_variable else None)

        for t in range(nt):
            out_t = self._calibrate_time(
                ofile, t, field_all[t], lats, lons, elevs, lafs,
                kidx, yi, xi, nn_elevs, g_obs, g_ci, g_radarl,
                l_idx, l_rho, l_mask, l_obs, l_ci, l_radar, l_s,
                has_obs, opts, use_bias, use_delta,
                newbias_all, newdelta_all, num_all)
            out_all[t] = out_t
        ofile.add_field(self.variable, out_all)
        if use_bias:
            ofile.add_field(self.bias_variable, newbias_all)
        if use_delta:
            ofile.add_field(self.delta_variable, newdelta_all)
        if self.num_variable:
            ofile.add_field(self.num_variable, num_all)

    # ---- one forecast time (Oi.cpp:325-1110) ---------------------------
    def _calibrate_time(self, ofile, t, field_raw, lats, lons, elevs,
                        lafs, kidx, yi, xi, nn_elevs, g_obs, g_ci,
                        g_radarl, l_idx, l_rho, l_mask, l_obs, l_ci,
                        l_radar, l_s, has_obs, opts, use_bias,
                        use_delta, newbias_all, newdelta_all, num_all):
        ny, nx, n_ens = field_raw.shape
        n = ny * nx
        field = np.where(np.isfinite(field_raw),
                         self._transform(field_raw.astype(np.float64)),
                         np.nan)

        bias = delta = None
        if use_bias:
            b = ofile.get_field(self.bias_variable)[t][:, :, 0].astype(
                np.float64)
            bias = np.where(np.isfinite(b), b * self.mu, 0.0)
        if use_delta:
            d = ofile.get_field(self.delta_variable)[t][:, :, 0].astype(
                np.float64)
            delta = np.where(np.isfinite(d), d, 1.0)

        # Y at station nearest-neighbours, with elevation correction
        # (Oi.cpp:379-417)
        st_elevs_k = np.asarray(opts.elevs, np.float64)
        fb = field.reshape(n, n_ens)[yi[kidx] * nx + xi[kidx]]  # (K, E)
        elev_corr = 0.0
        if _isvalid_f(self.elev_gradient) and self.elev_gradient != 0:
            elev_corr = self.elev_gradient * (
                st_elevs_k - nn_elevs[kidx])
            elev_corr = np.where(np.isfinite(elev_corr), elev_corr, 0.0)
            elev_corr = elev_corr[:, None]
        g_y = np.where(np.isfinite(fb), fb + elev_corr, 0.0)
        vcnt = np.isfinite(fb).sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            g_yhat = np.where(vcnt > 0, g_y.sum(axis=1)
                              / np.maximum(vcnt, 1), np.nan)
        g_y = np.where(np.isfinite(fb) & np.isfinite(g_yhat)[:, None],
                       g_y - g_yhat[:, None], g_y)
        if use_bias:
            g_yhat = g_yhat - bias[yi[kidx], xi[kidx]]

        # valid members: finite at every gridpoint (Oi.cpp:419-436)
        valid_ens = np.nonzero(
            np.isfinite(field.reshape(n, n_ens)).all(axis=0))[0]
        n_valid = valid_ens.size
        single = (not self.use_ens) or n_valid < self.min_valid_ens

        out = field.copy()
        sigma_transformed = np.zeros((ny, nx, n_ens))

        # local gathered tables (N, S, ...)
        l_y = np.where(l_mask[:, :, None], g_y[l_idx][:, :, valid_ens],
                       0.0)
        l_yhat = np.where(l_mask, g_yhat[l_idx], 0.0)
        innov = np.where(l_mask, l_obs - l_yhat, 0.0)

        rows = np.nonzero(has_obs)[0]
        if rows.size and n_valid > 0:
            if single:
                self._single_member_update(
                    rows, out, sigma_transformed, field, valid_ens,
                    l_y, l_yhat, l_obs, l_ci, l_rho, l_mask, use_bias,
                    opts, l_idx, lats, lons, elevs, lafs, ny, nx)
            else:
                self._ensemble_update(
                    rows, out, field, valid_ens, l_y, l_yhat, l_obs,
                    l_ci, l_rho, l_mask, l_radar, l_idx, l_s, innov,
                    use_bias, bias, delta, opts, ny, nx, num_all, t,
                    newbias_all)

        # rows without observations keep the background; saveDiff
        # blanks them (Oi.cpp:524-534)
        if self.save_diff:
            no_obs = ~has_obs.reshape(ny, nx)
            out[no_obs] = np.nan

        # ---- back-transform (Oi.cpp:1010-1076) -------------------------
        if single:
            if self.transform_type != "none":
                thr = self._transform(
                    np.float64(self.box_cox_threshold
                               if np.isfinite(self.box_cox_threshold)
                               else -999.0))
                for radius in (25, 5, 3):
                    sigma_transformed = np.where(out < thr, 0.0,
                                                 sigma_transformed)
                    for e in range(n_ens):
                        sigma_transformed[:, :, e] = nbh.neighbourhood(
                            sigma_transformed[:, :, e], radius,
                            gridpp.Mean)
                f = np.power(np.maximum(self.lambda_ * out + 1, 0.0),
                             1 / self.lambda_) if self.lambda_ != 0 \
                    else np.exp(out)
                f2 = np.power(
                    np.maximum((1 - self.lambda_)
                               * (self.lambda_ * out + 1), 0.0),
                    1 / self.lambda_ - 2) if self.lambda_ != 0 else \
                    np.exp(out)
                corrected = f + 0.5 * sigma_transformed * f2
                plain = self._inv_transform(out)
                res = np.where((sigma_transformed == 0) | (out < thr),
                               plain, corrected)
                out = np.where(np.isfinite(out), res, out)
                for e in range(n_ens):
                    out[:, :, e] = nbh.neighbourhood(
                        out[:, :, e], 3, gridpp.Mean)
        else:
            out = np.where(np.isfinite(out), self._inv_transform(out),
                           out)

        # delta update (Oi.cpp:1078-1086, 1093-1121)
        if use_delta:
            old = delta[0, 0]
            value = self._calc_delta(old, g_y)
            newdelta_all[t][:, :, :] = value
        return out.astype(np.float32)

    # ---- ensemble-member mode (Oi.cpp:678-1010) ------------------------
    def _ensemble_update(self, rows, out, field, valid_ens, l_y, l_yhat,
                         l_obs, l_ci, l_rho, l_mask, l_radar, l_idx,
                         l_s, innov, use_bias, bias, delta, opts, ny,
                         nx, num_all, t, newbias_all):
        n_valid = valid_ens.size
        m = l_mask[rows]                       # (R, S)
        y = l_y[rows]                          # (R, S, E)
        rho_r = np.where(m, l_rho[rows], 0.0)
        ci_r = np.where(m, l_ci[rows], 1.0)

        # R^-1: diagonal rho/(sigma^2 Ci); radar points get a correlated
        # block (Oi.cpp:734-806). numParameters==1 treated as Ci=1.
        rinv_diag = np.where(m, rho_r / (self.sigma ** 2 * ci_r), 0.0)
        radar = np.where(m, l_radar[rows] > 0, False)
        use_radar = bool(radar.any())

        if use_radar:
            rinv = self._radar_rinv(rows, m, rho_r, ci_r, radar, l_idx,
                                    opts)
        else:
            rinv = None

        # C = Y^T Rinv (R, E, S); Pinv = C Y + diag I  (E x E)
        if rinv is None:
            c_mat = y.transpose(0, 2, 1) * rinv_diag[:, None, :]
        else:
            c_mat = np.einsum("nse,nsr->nes", y, rinv)
        pinv = np.einsum("nes,nsf->nef", c_mat, y)
        if delta is None:
            curr_delta = np.full(rows.size, self.delta)
        else:
            curr_delta = delta.reshape(-1)[rows]
        diag = (n_valid - 1) / curr_delta
        if use_bias:
            diag = diag / (1 + self.gamma)
        idx = np.arange(n_valid)
        pinv[:, idx, idx] += diag[:, None]

        # batched inverse + eigendecomposition; singular rows keep the
        # raw ensemble (Oi.cpp:809-817 "Using raw values")
        ok = np.isfinite(pinv).all(axis=(1, 2))
        pinv_ok = np.where(ok[:, None, None], pinv,
                           np.eye(n_valid)[None])
        with np.errstate(all="ignore"):
            cond = np.linalg.cond(pinv_ok)
        ok &= np.isfinite(cond) & (cond < 1e12)
        pinv_ok = np.where(ok[:, None, None], pinv_ok,
                           np.eye(n_valid)[None])
        p = np.linalg.inv(pinv_ok)
        ok &= np.isfinite(p).all(axis=(1, 2))
        eigval, eigvec = np.linalg.eigh(
            (n_valid - 1) * np.where(ok[:, None, None], p,
                                     np.eye(n_valid)[None]))
        ok &= eigval[:, 0] > -1e-8  # sqrt of negative eigenvalue
        eigval = np.sqrt(np.maximum(eigval, 0.0))
        w_mat = np.einsum("nij,nj,nkj->nik", eigvec, eigval, eigvec)

        pc = np.einsum("nef,nfs->nes", p, c_mat)
        if self.diagnose:
            rhs = np.where(m, 1.0, 0.0)
        else:
            rhs = innov[rows]
        w_vec = np.einsum("nes,ns->ne", pc, rhs)
        w_full = w_mat + w_vec[:, :, None]

        # X: member anomalies at the gridpoint
        xg = field.reshape(-1, field.shape[-1])[rows][:, valid_ens]
        ens_mean = xg.mean(axis=1)
        x_anom = xg - ens_mean[:, None]

        increment = np.einsum("nk,nke->ne", x_anom, w_full)

        if self.save_diff:
            res = increment
        else:
            if not self.extrapolate:
                # anti-extrapolation clamp per member (Oi.cpp:938-974)
                oi_inc = np.where(m[:, :, None],
                                  (l_obs[rows][:, :, None] - (y
                                   + l_yhat[rows][:, :, None])),
                                  np.nan)
                max_inc = np.nanmax(np.where(np.isnan(oi_inc), -np.inf,
                                             oi_inc), axis=1)
                min_inc = np.nanmin(np.where(np.isnan(oi_inc), np.inf,
                                             oi_inc), axis=1)
                member_inc = increment - x_anom
                c1 = (max_inc > 0) & (member_inc > max_inc)
                c2 = ~c1 & (max_inc < 0) & (member_inc > 0)
                c3 = ~c1 & ~c2 & (min_inc < 0) & (member_inc < min_inc)
                c4 = ~c1 & ~c2 & ~c3 & (min_inc > 0) & (member_inc < 0)
                increment = np.where(
                    c1, max_inc + x_anom,
                    np.where(c2, x_anom,
                             np.where(c3, min_inc + x_anom,
                                      np.where(c4, x_anom, increment))))
            res = ens_mean[:, None] + increment

        res = np.where(ok[:, None], res, xg)
        flat_out = out.reshape(-1, out.shape[-1])
        flat_out[rows[:, None], valid_ens[None, :]] = res

        if num_all is not None:
            num_flat = num_all[t].reshape(-1, num_all.shape[-1])
            num_flat[rows[:, None], valid_ens[None, :]] = \
                l_s[rows][:, None]

        if use_bias:
            bias_total = np.einsum("ne,ne->n", xg, w_vec)
            nb = bias.reshape(-1)[rows] - self.gamma / (1 + self.gamma) \
                * np.where(ok, bias_total, 0.0)
            nb_flat = newbias_all[t].reshape(-1, newbias_all.shape[-1])
            nb_flat[rows, 0] = nb

    def _radar_rinv(self, rows, m, rho_r, ci_r, radar, l_idx, opts):
        """Full R^-1 with the radar covariance block (Oi.cpp:744-806)."""
        r, s = m.shape
        rinv = np.zeros((r, s, s))
        idx = np.arange(s)
        rinv[:, idx, idx] = np.where(
            m, rho_r / (self.sigma ** 2 * ci_r), 0.0)
        oxyz = opts.xyz
        for i in np.nonzero(radar.any(axis=1))[0]:
            ri = np.nonzero(radar[i])[0]
            ids = l_idx[rows[i], ri]
            d = np.sqrt(((oxyz[ids][:, None, :]
                          - oxyz[ids][None, :, :]) ** 2).sum(-1))
            h = d / self.hlength_c
            radar_r = (1 + h) * np.exp(-h)
            np.fill_diagonal(radar_r, 1.0)
            try:
                radar_rinv = np.linalg.inv(radar_r)
            except np.linalg.LinAlgError:
                continue
            sq = np.sqrt(rho_r[i][ri][:, None] * rho_r[i][ri][None, :])
            rinv[i][np.ix_(ri, ri)] = sq / (self.sigma_c ** 2) \
                * radar_rinv
        return rinv

    # ---- single-member mode (Oi.cpp:562-676) ---------------------------
    def _single_member_update(self, rows, out, sigma_transformed, field,
                              valid_ens, l_y, l_yhat, l_obs, l_ci,
                              l_rho, l_mask, use_bias, opts, l_idx,
                              lats, lons, elevs, lafs, ny, nx):
        m = l_mask[rows]
        r, s = m.shape
        # station-pair correlation matrix P (Oi.cpp:569-597)
        oxyz = opts.xyz
        ids = l_idx[rows]                       # (R, S)
        d = np.sqrt(((oxyz[ids][:, :, None, :]
                      - oxyz[ids][:, None, :, :]) ** 2).sum(-1))
        st_e = np.asarray(opts.elevs, np.float64)[ids]
        vdist = st_e[:, :, None] - st_e[:, None, :]
        st_l = np.asarray(opts.lafs, np.float64)[ids]
        grid_laf = lafs.reshape(-1)[rows]
        both = (np.isfinite(st_l)[:, :, None]
                & np.isfinite(grid_laf)[:, None, None])
        lafdist = np.where(both, st_l[:, :, None] - st_l[:, None, :],
                           0.0)
        with np.errstate(invalid="ignore"):
            p_mat = self._calc_rho(d, vdist, lafdist)
        p_mat = np.where(m[:, :, None] & m[:, None, :],
                         np.nan_to_num(p_mat, nan=0.0), 0.0)

        g = np.where(m, l_rho[rows], 0.0)       # (R, S)
        eps2 = self.epsilon ** 2
        if use_bias:
            eps2 = eps2 / (1 + self.gamma)
        sr = p_mat.copy()
        idx = np.arange(s)
        # P + eps^2 R (R diag = Ci); masked slots get identity rows so
        # the padded system stays invertible (their G entry is 0)
        sr[:, idx, idx] += np.where(m, eps2 * l_ci[rows], 1.0)
        try:
            srinv = np.linalg.inv(sr)
        except np.linalg.LinAlgError:
            return
        gsr = np.einsum("ns,nst->nt", g, srinv)  # (R, S)

        thr = self._transform(np.float64(self.box_cox_threshold
                                         if np.isfinite(
                                             self.box_cox_threshold)
                                         else -999.0))
        flat_field = field.reshape(-1, field.shape[-1])
        flat_out = out.reshape(-1, out.shape[-1])
        sig_flat = sigma_transformed.reshape(-1,
                                             sigma_transformed.shape[-1])
        for e_i, ei in enumerate(valid_ens):
            curr = np.where(m, l_y[rows][:, :, e_i]
                            + l_yhat[rows], 0.0)
            resid = np.where(m, l_obs[rows] - curr, 0.0)
            dx = np.einsum("ns,ns->n", gsr, resid)
            base = flat_field[rows, ei]
            new = np.where(np.isfinite(base), base + dx, base)
            if self.transform_type != "none":
                new = np.maximum(new, -1.0 / self.lambda_)
                # variance of the analysis in transformed space
                # (Oi.cpp:622-646)
                above = new >= thr
                if above.any():
                    inc_at_obs = np.einsum("nst,nt->ns", p_mat,
                                           np.einsum("nst,nt->ns",
                                                     srinv, resid))
                    tot = np.einsum("ns,ns->n", resid,
                                    resid - inc_at_obs)
                    # totalDiagR += epsilon^2 * R(s,s), R diag = Ci
                    # (Oi.cpp:632-634)
                    tot_diag_r = np.where(
                        m, self.epsilon ** 2 * l_ci[rows],
                        0.0).sum(axis=1)
                    gsrg = np.einsum("ns,ns->n", gsr, g)
                    ls = np.maximum(m.sum(axis=1), 1)
                    sigma_obs = tot / ls
                    mean_diag_r = tot_diag_r / ls
                    with np.errstate(divide="ignore", invalid="ignore"):
                        sigma_b = np.where(mean_diag_r > 0,
                                           sigma_obs / mean_diag_r, 0.0)
                    sig = np.maximum(0.001, sigma_b * (1 - gsrg))
                    sig_flat[rows, ei] = np.where(above, sig,
                                                  sig_flat[rows, ei])
            flat_out[rows, ei] = new

    # ---- delta evolution (Oi.cpp:1093-1121) ----------------------------
    def _calc_delta(self, old_delta, g_y):
        delta_var = self.c - 1
        vals = np.asarray(g_y, np.float64)
        fin = np.isfinite(vals)
        cnt = fin.sum(axis=1)
        use = cnt > 1
        if not use.any():
            return old_delta
        ss = np.where(fin, vals, 0.0)
        var = (ss ** 2).sum(axis=1)[use] / (cnt[use] - 1)
        trace = var.sum()
        num_valid = use.sum()
        numerator = self.sigma ** 2 / self.epsilon ** 2
        denominator = trace / num_valid
        evidence = numerator / denominator
        w_old = delta_var
        w_new = self.new_delta_var
        return (old_delta * w_new + evidence * w_old) / (w_old + w_new)
