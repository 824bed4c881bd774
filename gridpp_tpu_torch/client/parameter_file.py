"""Parameter files (reference src/client/ParameterFile/{ParameterFile,
Text}.cpp).

Text format: whitespace table with a header naming `time` and optionally
`lat lon elev` plus parameter columns. Spatial files provide
nearest-location lookup.
"""
from __future__ import annotations

import numpy as np

from ..core.points import Points


class ParameterFileText:
    def __init__(self, filename, options=None):
        self.filename = filename
        self.times = []
        self.spatial = False
        # rows: list of (time, lat, lon, elev, params...)
        lats, lons, elevs = [], [], []
        records = []
        with open(filename) as f:
            header = None
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if header is None:
                    header = line.split()
                    self.columns = header
                    self._time_pos = header.index("time") \
                        if "time" in header else None
                    self._lat_pos = header.index("lat") \
                        if "lat" in header else None
                    self._lon_pos = header.index("lon") \
                        if "lon" in header else None
                    self._elev_pos = header.index("elev") \
                        if "elev" in header else None
                    spatial_cols = sum(p is not None for p in
                                       (self._lat_pos, self._lon_pos,
                                        self._elev_pos))
                    if 0 < spatial_cols < 3:
                        raise RuntimeError(
                            "Partial spatial definitions found")
                    self.spatial = spatial_cols == 3
                    continue
                # the client's missing-value sentinel is -999
                # (reference src/client/Util.h MV); map to NaN
                values = [np.nan if float(v) == -999 else float(v)
                          for v in line.split()]
                records.append(values)
        skip = {p for p in (self._time_pos, self._lat_pos, self._lon_pos,
                            self._elev_pos) if p is not None}
        param_cols = [i for i in range(len(self.columns)) if i not in skip]
        self._records = records
        self._param_cols = param_cols
        if self.spatial:
            self._lats = np.array([r[self._lat_pos] for r in records])
            self._lons = np.array([r[self._lon_pos] for r in records])
            self._elevs = np.array([r[self._elev_pos] for r in records])
        self._times = np.array(
            [r[self._time_pos] if self._time_pos is not None else 0
             for r in records])
        self._params = np.array([[r[c] for c in param_cols]
                                 for r in records], np.float32)

    def is_location_dependent(self) -> bool:
        """Whether parameters vary by location (ParameterFile.h:16-60)."""
        return self.spatial

    def params_for_locations(self, time, lats, lons):
        """(N, P) parameter rows for N query locations.

        Spatial files resolve each location to its nearest parameter
        point (ParameterFile nearest-location lookup); non-spatial files
        broadcast the single time-matched row.
        """
        lats = np.asarray(lats, np.float64).ravel()
        if not self.spatial:
            row = self.parameters_at_time(time)
            return np.broadcast_to(row, (lats.size, row.size)).copy()
        points, params = self.to_points(time)
        idx = points.index.nearest(lats, np.asarray(lons,
                                                    np.float64).ravel())
        return params[idx]

    def parameters_at_time(self, time):
        """Parameter vector for the nearest available time (non-spatial)."""
        if len(self._times) == 0:
            return np.zeros(0, np.float32)
        i = int(np.argmin(np.abs(self._times - time)))
        return self._params[i]

    def to_points(self, time=None):
        """(Points, params[S, P]) for spatial parameter files."""
        if not self.spatial:
            raise RuntimeError("Parameter file has no locations")
        if time is None:
            mask = np.ones(len(self._times), bool)
        else:
            tsel = self._times[np.argmin(np.abs(self._times - time))]
            mask = self._times == tsel
        points = Points(self._lats[mask], self._lons[mask],
                        self._elevs[mask])
        return points, self._params[mask]


def _read_netcdf_vars(filename):
    """Read every variable of a NetCDF3/NetCDF4 file into
    {name: (dims tuple, array)} with _FillValue/missing_value converted
    to NaN (reference getNcFloats, Netcdf.cpp:498-518).

    scipy handles classic NetCDF3; HDF5-based NetCDF4 needs the netCDF4
    package and gets a clear error when it is absent.
    """
    def _with_fill_nan(data, fills):
        if data.dtype.kind == "f":
            if all(f is None for f in fills):
                fills = (9.9692099683868690e+36,)  # default NC_FILL_FLOAT
            for fv in fills:
                if fv is not None:
                    data = np.where(data == data.dtype.type(fv), np.nan,
                                    data)
        return data

    try:
        from scipy.io import netcdf_file
        nc = netcdf_file(filename, "r", mmap=False)
    except Exception:
        nc = None
    if nc is not None:
        try:
            out = {}
            for name, var in nc.variables.items():
                data = np.array(var.data if var.data.ndim == 0 else var[:])
                fills = (getattr(var, "_FillValue", None),
                         getattr(var, "missing_value", None))
                out[name] = (tuple(var.dimensions),
                             _with_fill_nan(data, fills))
            return out
        finally:
            nc.close()
    try:
        import netCDF4
    except ImportError:
        raise RuntimeError(
            f"Cannot open '{filename}': NetCDF4 parameter files need the "
            "netCDF4 package (not installed); NetCDF3 is supported "
            "natively")
    ds = netCDF4.Dataset(filename, "r")
    try:
        out = {}
        for name, var in ds.variables.items():
            data = np.asarray(var[:])
            if np.ma.isMaskedArray(data):
                data = data.filled(np.nan)
            fills = (getattr(var, "_FillValue", None),
                     getattr(var, "missing_value", None))
            out[name] = (tuple(var.dimensions),
                         _with_fill_nan(data, fills))
        return out
    finally:
        ds.close()


class ParameterFileNetcdf:
    """Gridded parameter sets (reference ParameterFile/Netcdf.cpp).

    Layout: 2-D lat/lon variables, optional altitude and time, and a
    coefficient variable over (time?, <spatial dims>, coeff) in any
    dimension order (Netcdf.cpp:115-190 handles arbitrary ordering; here
    we transpose by dimension name). NetCDF3 via scipy.
    """

    def __init__(self, filename, options=None):
        self.filename = filename
        self.spatial = True
        opt = options
        var_name = (opt.get("varName", "coefficient")
                    if opt is not None else "coefficient")
        dim_name = (opt.get("dimName", "coeff")
                    if opt is not None else "coeff")
        variables = _read_netcdf_vars(filename)

        def find_var(*names):
            for n in names:
                if n in variables:
                    return variables[n]
            return None

        vlat = find_var("lat", "latitude")
        vlon = find_var("lon", "longitude")
        if vlat is None or vlon is None:
            raise RuntimeError(
                "Could not determine latitude/longitude variable")
        lat_dims, lats = vlat
        lon_dims, lons = vlon
        lats = lats.astype(np.float64)
        lons = lons.astype(np.float64)
        if lats.ndim == 1 and lons.ndim == 1 \
                and lat_dims != lon_dims:
            # 1-D coordinate variables: broadcast to the 2-D grid
            # (reference Netcdf.cpp getGridValues numDims==1 branch)
            lats, lons = np.meshgrid(lats, lons, indexing="ij")
            spatial_dims = [lat_dims[0], lon_dims[0]]
        else:
            if lon_dims != lat_dims:
                # Normalize lon's dim order to lat's (reference
                # getGridValues normalizes each variable independently)
                lons = lons.transpose([lon_dims.index(d)
                                       for d in lat_dims])
            spatial_dims = list(lat_dims)
        valt = find_var("altitude")
        if valt is not None:
            alt_dims, elevs = valt
            elevs = elevs.astype(np.float64)
            if tuple(alt_dims) == tuple(lat_dims) and elevs.ndim > 1:
                pass  # already lat-ordered
            elif elevs.shape == lats.shape:
                pass
            elif set(alt_dims) == set(lat_dims):
                elevs = elevs.transpose([alt_dims.index(d)
                                         for d in lat_dims])
            else:
                elevs = np.broadcast_to(elevs, lats.shape)
        else:
            elevs = np.full(lats.shape, np.nan)
        vtime = find_var("time")
        times = (vtime[1].astype(np.float64).ravel()
                 if vtime is not None else np.zeros(1))

        if var_name not in variables:
            raise RuntimeError(f"No variable '{var_name}' in {filename}")
        dims, coef_raw = variables[var_name]
        dims = list(dims)
        if dim_name not in dims:
            raise RuntimeError(
                f"Coefficients in {filename} missing '{dim_name}' "
                "dimension")
        for d in spatial_dims:
            if d not in dims:
                raise RuntimeError(
                    f"Coefficients in {filename} missing spatial "
                    f"dimension '{d}'")
        order = []
        if "time" in dims:
            order.append(dims.index("time"))
        order += [dims.index(d) for d in spatial_dims]
        order.append(dims.index(dim_name))
        if len(order) != coef_raw.ndim:
            raise RuntimeError(
                f"Coefficients in {filename} have unsupported extra "
                f"dimensions: {dims}")
        coef = coef_raw.astype(np.float32).transpose(order)
        if "time" not in dims:
            coef = coef[None]

        n_time = coef.shape[0]
        n_coeff = coef.shape[-1]
        self._file_times = times[:n_time] if len(times) >= n_time \
            else np.arange(n_time, dtype=np.float64)
        self._lats_flat = lats.ravel()
        self._lons_flat = lons.ravel()
        self._elevs_flat = elevs.ravel()
        # (T, S, P)
        self._coef = coef.reshape(n_time, -1, n_coeff)
        self._points = Points(self._lats_flat, self._lons_flat,
                              self._elevs_flat)

    def is_location_dependent(self) -> bool:
        return True

    def _time_index(self, time):
        return int(np.argmin(np.abs(self._file_times - time)))

    def params_for_locations(self, time, lats, lons):
        """(N, P) nearest-location parameter rows for time (nearest)."""
        lats = np.asarray(lats, np.float64).ravel()
        lons = np.asarray(lons, np.float64).ravel()
        idx = self._points.index.nearest(lats, lons)
        return self._coef[self._time_index(time)][idx]

    def parameters_at_time(self, time):
        """Unsupported: gridded parameter files are location-dependent.

        The reference has no spatial-averaging accessor either; callers
        must use params_for_locations (matches ParameterFileText.to_points
        raising for the inverse mismatch)."""
        raise RuntimeError(
            "Parameter file is location-dependent; use "
            "params_for_locations")

    def to_points(self, time=None):
        t = 0 if time is None else self._time_index(time)
        return self._points, self._coef[t]


class ParameterFileSimple:
    """In-memory location-independent parameter set (reference
    ParameterFile/Simple.cpp): one parameter row, valid at time 0."""

    def __init__(self, parameters):
        self.filename = None
        self.spatial = False
        self._params = np.asarray(parameters, np.float32).ravel()

    def is_location_dependent(self) -> bool:
        return False

    def get_times(self):
        return [0]

    def parameters_at_time(self, time):
        return self._params

    def params_for_locations(self, time, lats, lons):
        lats = np.asarray(lats, np.float64).ravel()
        return np.broadcast_to(self._params,
                               (lats.size, self._params.size)).copy()


def get_parameter_file(name, options=None):
    """Autodetect parameter format by magic bytes (text vs NetCDF)."""
    try:
        with open(name, "rb") as f:
            magic = f.read(4)
    except OSError:
        magic = b""
    if magic[:3] == b"CDF" or magic == b"\x89HDF":
        return ParameterFileNetcdf(name, options)
    return ParameterFileText(name, options)
