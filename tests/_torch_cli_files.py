"""NetCDF3 files for the client tests (tests/test_torch_client.py, and the
card's tests/test_torch_cuda.py): a forecast and an output template
written with scipy, the CLI's argv over them, and a float64 windowed Std.
Imports no jax."""
import numpy as np

K1_BARS = dict(rtol=1e-5, atol=1e-4)     # tests/test_pallas_stencil.py:36-38
BILINEAR_BARS = dict(rtol=1e-6, atol=1e-4)
# output variable -> (its options after the downscaler, its bars). The
# two packages' bilinear fields part within BILINEAR_BARS (3e-5 here), so
# Max and the clamp, which move no more than their input, are held there;
# Std on a 280 K field is F14's (None: see test_std_against_float64).
VARIABLES = {
    "t_bilinear": ([], BILINEAR_BARS),
    "t_mean": (["-c", "neighbourhood", "radius=3", "stat=mean"], K1_BARS),
    "t_max": (["-c", "neighbourhood", "radius=3", "stat=max"],
              BILINEAR_BARS),
    "t_std": (["-c", "neighbourhood", "radius=3", "stat=std"], None),
    "t_window": (["-c", "window", "length=3", "stat=mean"], K1_BARS),
    "t_qc": (["-c", "qc", "min=279", "max=283"], BILINEAR_BARS),
}


def _grid_vars(nc, lats, lons, elevs):
    for name, data in (("latitude", lats), ("longitude", lons)):
        v = nc.createVariable(name, "d", ("y", "x"))
        v[:] = data
    v = nc.createVariable("altitude", "f", ("y", "x"))
    v[:] = elevs.astype(np.float32)


def write_files(path_in, path_out, nt=3, shape_in=(30, 25),
                shape_out=(41, 37), seed=0):
    """A NetCDF3 forecast (nt leads of air_temperature_2m, K, on a
    shape_in grid with altitude) and an output template (shape_out, with
    altitude) over the same domain, written with scipy."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(seed)
    for path, (ny, nx), with_field in ((path_in, shape_in, True),
                                       (path_out, shape_out, False)):
        lats, lons = np.meshgrid(np.linspace(59, 61, ny),
                                 np.linspace(9, 11.5, nx), indexing="ij")
        elevs = rng.uniform(0, 800, (ny, nx))
        nc = netcdf_file(str(path), "w", mmap=False)
        nc.createDimension("time", nt)
        nc.createDimension("y", ny)
        nc.createDimension("x", nx)
        t = nc.createVariable("time", "d", ("time",))
        t[:] = 1.7e9 + 3600.0 * np.arange(nt)
        _grid_vars(nc, lats, lons, elevs)
        if with_field:
            v = nc.createVariable("air_temperature_2m", "f",
                                  ("time", "y", "x"))
            field = (281 - 0.0065 * elevs + rng.normal(0, 2, (nt, ny, nx)))
            field[0, 3, 4] = np.nan
            v[:] = field.astype(np.float32)
        nc.close()


def cli_argv(path_in, path_out):
    argv = [str(path_in), str(path_out)]
    for name, (calib, _) in VARIABLES.items():
        argv += ["-vi", "air_temperature_2m", "-v", name, "-d",
                 "bilinear"] + calib
    return argv


def read_outputs(path):
    from scipy.io import netcdf_file
    nc = netcdf_file(str(path), "r", mmap=False)
    out = {name: np.array(nc.variables[name][:]) for name in VARIABLES}
    nc.close()
    return out


def window_std64(x, h):
    """Windowed Std of each (Y, X) plane of x in float64, non-finite
    values skipped, windows clipped at the edges: the reference values
    for Std on fields far from 0."""
    x = np.asarray(x, np.float64)
    ok = np.isfinite(x)
    xc = np.where(ok, x - np.nanmean(np.where(ok, x, np.nan)), 0.0)

    def box(v):
        ny, nx = v.shape[-2:]
        c = np.zeros(v.shape[:-2] + (ny + 1, nx + 1))
        c[..., 1:, 1:] = v.cumsum(-2).cumsum(-1)
        y0 = np.clip(np.arange(ny) - h, 0, ny)
        y1 = np.clip(np.arange(ny) + h + 1, 0, ny)
        x0 = np.clip(np.arange(nx) - h, 0, nx)
        x1 = np.clip(np.arange(nx) + h + 1, 0, nx)
        return (c[..., y1[:, None], x1] - c[..., y0[:, None], x1]
                - c[..., y1[:, None], x0] + c[..., y0[:, None], x0])

    n = box(ok.astype(np.float64))
    with np.errstate(invalid="ignore", divide="ignore"):
        m = box(xc) / n
        var = box(xc * xc) / n - m * m
    return np.where(n > 0, np.sqrt(np.maximum(var, 0.0)), np.nan)
