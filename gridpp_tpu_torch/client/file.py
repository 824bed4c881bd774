"""File abstraction: lazy field cache over NetCDF (reference
src/client/File/{File,Netcdf,Fake}.cpp).

Fields are (T, Y, X, E) numpy arrays cached per variable. FileNetcdf
autodetects common MET-Norway dimension/variable layouts (time, y/x or
lat/lon dims, optional ensemble_member dim) in NetCDF3 files via scipy.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ..constants import MV
from ..core.grid import Grid
from .options import Options

_LAT_NAMES = ("latitude", "lat", "lats")
_LON_NAMES = ("longitude", "lon", "lons")
_ELEV_NAMES = ("altitude", "surface_geopotential", "elev")
_LAF_NAMES = ("land_area_fraction", "laf")
_TIME_NAMES = ("time",)
_ENS_NAMES = ("ensemble_member", "ens", "member")


class File:
    """Base: holds a Grid, times, and a lazy field cache."""

    def __init__(self):
        self._fields: dict[str, np.ndarray] = {}
        self.grid: Grid | None = None
        self.times: np.ndarray = np.zeros(0)
        self.num_ens = 1
        self.reference_time = None

    def has_variable(self, name) -> bool:
        raise NotImplementedError

    def get_field(self, name) -> np.ndarray:
        """(T, Y, X, E) field, cached."""
        if name not in self._fields:
            self._fields[name] = self._read_field(name)
        return self._fields[name]

    def add_field(self, name, values):
        values = np.asarray(values, np.float32)
        assert values.ndim == 4
        self._fields[name] = values

    def get_cache_size(self) -> int:
        return sum(v.nbytes for v in self._fields.values())

    def _read_field(self, name):
        raise NotImplementedError

    def write(self, variables, history=""):
        raise NotImplementedError

    @staticmethod
    def open(filename, options=None):
        """Autodetect the file backend (File/File.cpp:19-57)."""
        ftype = options.get("type") if options else None
        if ftype == "fake":
            return FileFake()
        if ftype == "point":
            return FilePoint(filename, options)
        if ftype == "text":
            return FileText(filename, options)
        if ftype == "norcomQnh":
            return FileNorcomQnh(filename, options)
        if ftype not in (None, "netcdf"):
            raise RuntimeError(f"Could not understand file type {ftype}")
        return FileNetcdf(filename, options)


# Cap on attribute sizes, like the reference's guard against runaway
# history attributes (Testing/FileNetcdf.cpp setLongAttribute)
_MAX_ATTR_LENGTH = int(1e7)


class FileNetcdf(File):
    """NetCDF file with flexible dim/variable naming (File/Netcdf.cpp).

    Autodetects coordinate/dimension names from the standard candidates
    (_LAT_NAMES etc.); explicit `xDim= yDim= timeDim= ensDim= latVar=
    lonVar= elevVar= timeVar=` options override the detection
    (Netcdf.cpp:60-120, Testing/FileNetcdf.cpp dimNames). Fields are
    reoriented to (T, Y, X, E) using each variable's own dimension
    order, so variables with flipped y/x dims read correctly."""

    def __init__(self, filename, options=None):
        super().__init__()
        self.filename = filename
        self._options = options
        try:
            from scipy.io import netcdf_file
            self._nc = netcdf_file(filename, "r", mmap=False)
            self._backend = "scipy"
        except Exception:
            try:
                import netCDF4
                self._nc = netCDF4.Dataset(filename, "r")
                self._backend = "netcdf4"
            except ImportError:
                raise RuntimeError(
                    f"Cannot open '{filename}': NetCDF4 files need the "
                    "netCDF4 package (not installed); NetCDF3 is supported "
                    "natively")
        self._load_attrs()
        self._parse()

    def _opt(self, key):
        return self._options.get(key) if self._options else None

    def _var(self, names):
        for name in names:
            if name in self._nc.variables:
                return self._nc.variables[name]
        return None

    def _dim_size(self, names):
        for name in names:
            if name in self._nc.dimensions:
                size = self._nc.dimensions[name]
                if not isinstance(size, int):
                    size = len(size)
                if size is None:  # unlimited: infer from the time var
                    v = self._var([name])
                    size = v.shape[0] if v is not None else 1
                return name, size
        return None, None

    @staticmethod
    def _clean(var):
        """Variable data with _FillValue/missing_value -> NaN."""
        data = np.array(var[:], np.float64)
        fills = [getattr(var, a, None)
                 for a in ("_FillValue", "missing_value")]
        if all(f is None for f in fills):
            fills = [9.9692099683868690e+36]
        for fv in fills:
            if fv is not None:
                data = np.where(np.isclose(data, float(fv), rtol=1e-6),
                                np.nan, data)
        return data

    def _orient_2d(self, var):
        """A per-gridpoint variable (e.g. altitude) oriented to (Y, X)
        using its own dims — handles flipped y/x (dimNames fixture)."""
        data = self._clean(var)
        dims = list(var.dimensions)
        # squeeze singleton non-y/x axes
        for i in reversed(range(len(dims))):
            if dims[i] not in (self._ydim, self._xdim) and \
                    data.shape[i] == 1:
                data = np.squeeze(data, axis=i)
                dims.pop(i)
        if data.ndim == 2 and dims == [self._xdim, self._ydim]:
            data = data.T
        return data

    def _parse(self):
        lat_var = self._var((self._opt("latVar"),) if self._opt("latVar")
                            else _LAT_NAMES)
        lon_var = self._var((self._opt("lonVar"),) if self._opt("lonVar")
                            else _LON_NAMES)
        if lat_var is None or lon_var is None:
            raise RuntimeError(
                f"File '{self.filename}' has no lat/lon information")
        # Dimension-name resolution: options override; else the lat
        # variable's own dims (2-D case); else 'y'/'x' when present
        self._tdim = self._opt("timeDim") or \
            next((d for d in _TIME_NAMES if d in self._nc.dimensions),
                 "time")
        self._edim = self._opt("ensDim") or \
            next((d for d in _ENS_NAMES if d in self._nc.dimensions), None)
        ydim, xdim = self._opt("yDim"), self._opt("xDim")
        if (ydim and ydim not in self._nc.dimensions) or \
                (xdim and xdim not in self._nc.dimensions):
            raise RuntimeError(
                f"Missing dimension in file '{self.filename}'")
        lat_dims = list(lat_var.dimensions)
        if len(lat_dims) == 2:
            ydim = ydim or lat_dims[0]
            xdim = xdim or lat_dims[1]
        else:
            ydim = ydim or ("y" if "y" in self._nc.dimensions else None)
            xdim = xdim or ("x" if "x" in self._nc.dimensions else None)
        self._ydim, self._xdim = ydim, xdim

        lats = self._clean(lat_var)
        lons = self._clean(lon_var)
        if lats.ndim == 1:
            d = lat_dims[0] if lat_dims else None
            if d is not None and d == (lon_var.dimensions or [None])[0]:
                # single shared axis: a row (along x) or column (along y)
                if d == self._ydim:
                    lats, lons = lats[:, None], lons[:, None]
                else:
                    lats, lons = lats[None, :], lons[None, :]
            else:
                lats, lons = np.meshgrid(lats, lons, indexing="ij")
        elif lats.ndim == 2 and list(lat_var.dimensions) == \
                [self._xdim, self._ydim]:
            lats, lons = lats.T, lons.T

        elevs = None
        elev_var = self._var((self._opt("elevVar"),)
                             if self._opt("elevVar") else _ELEV_NAMES)
        if elev_var is not None:
            ev = self._orient_2d(elev_var)
            while ev.ndim > 2:
                ev = ev[0]
            name = self._opt("elevVar") or next(
                n for n in _ELEV_NAMES if n in self._nc.variables)
            std_name = getattr(elev_var, "standard_name", "")
            if isinstance(std_name, bytes):
                std_name = std_name.decode()
            if name == "surface_geopotential" or \
                    "geopotential" in std_name:
                ev = ev / 9.81  # Netcdf.cpp:78-80
            elevs = ev
        lafs = None
        laf_var = self._var(_LAF_NAMES)
        if laf_var is not None:
            lv = self._orient_2d(laf_var)
            while lv.ndim > 2:
                lv = lv[0]
            lafs = lv
        self.grid = Grid(lats, lons,
                         elevs if elevs is not None else (),
                         lafs if lafs is not None else ())

        ref_var = self._var(("forecast_reference_time",))
        if ref_var is not None:
            try:
                self.reference_time = float(np.asarray(ref_var.data))
            except Exception:
                self.reference_time = None
        time_var = self._var((self._opt("timeVar"),)
                             if self._opt("timeVar") else _TIME_NAMES)
        if time_var is not None:
            tdata = np.asarray(time_var.data
                               if self._backend == "scipy"
                               else time_var[:])
            # scalar time variable (no dimension): one analysis time
            self.times = np.atleast_1d(np.array(tdata, np.float64))
        elif self.reference_time is not None:
            # analysis file: no time axis, use forecast_reference_time
            # (Netcdf.cpp / Testing/FileNetcdf.cpp analysis)
            self.times = np.array([self.reference_time], np.float64)
        else:
            self.times = np.zeros(1)
        if self._edim is not None:
            _, ens_size = self._dim_size((self._edim,))
        else:
            _, ens_size = self._dim_size(_ENS_NAMES)
        self.num_ens = ens_size or 1

    # --- attributes (Netcdf.cpp attribute API) -------------------------
    def _load_attrs(self):
        if self._backend == "scipy":
            self._gattrs = {
                k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in dict(getattr(self._nc, "_attributes",
                                         {})).items()}
            self._vattrs = {
                name: {k: (v.decode() if isinstance(v, bytes) else v)
                       for k, v in dict(getattr(var, "_attributes",
                                                {})).items()}
                for name, var in self._nc.variables.items()}
        else:  # pragma: no cover - netCDF4 backend
            self._gattrs = {k: self._nc.getncattr(k)
                            for k in self._nc.ncattrs()}
            self._vattrs = {name: {k: var.getncattr(k)
                                   for k in var.ncattrs()}
                            for name, var in self._nc.variables.items()}

    def get_global_attribute(self, key) -> str:
        value = self._gattrs.get(key, "")
        return value if isinstance(value, str) else str(value)

    def set_global_attribute(self, key, value):
        value = str(value)
        if len(value) > _MAX_ATTR_LENGTH:
            print(f"Warning: attribute '{key}' too long; not set")
            return
        self._gattrs[key] = value

    def append_global_attribute(self, key, value):
        old = self.get_global_attribute(key)
        self.set_global_attribute(key,
                                  f"{old}\n{value}" if old else str(value))

    def prepend_global_attribute(self, key, value):
        old = self.get_global_attribute(key)
        self.set_global_attribute(key,
                                  f"{value}\n{old}" if old else str(value))

    def get_attribute(self, variable, key) -> str:
        if variable not in self._vattrs:
            raise RuntimeError(f"Variable '{variable}' not in file")
        value = self._vattrs[variable].get(key, "")
        return value if isinstance(value, str) else str(value)

    def set_attribute(self, variable, key, value):
        if variable not in self._vattrs:
            raise RuntimeError(f"Variable '{variable}' not in file")
        value = str(value)
        if len(value) > _MAX_ATTR_LENGTH:
            print(f"Warning: attribute '{key}' too long; not set")
            return
        self._vattrs[variable][key] = value

    def has_variable(self, name):
        return name in self._nc.variables

    def _read_field(self, name):
        if name not in self._nc.variables:
            raise RuntimeError(
                f"Variable '{name}' not in file '{self.filename}'")
        var = self._nc.variables[name]
        data = np.array(var[:], np.float32)
        # _FillValue/missing_value -> NaN (reference getNcFloats,
        # Netcdf.cpp:498-518); files without an explicit attribute use
        # the library default NC_FILL_FLOAT
        fills = [getattr(var, a, None)
                 for a in ("_FillValue", "missing_value")]
        if all(f is None for f in fills):
            # no declared fill: the library default plus the legacy
            # client's missing-value convention of -999 (client
            # Util::MV; e.g. tests/files/validNetcdfAnalysis.nc stores
            # missing members as raw -999 with no fill attribute). A
            # DECLARED fill suppresses the -999 heuristic so legitimate
            # -999 data survives.
            fills = [9.9692099683868690e+36, -999.0]
        for fv in fills:
            if fv is not None:
                data = np.where(data == np.float32(fv), np.nan, data)
        sf = getattr(var, "scale_factor", None)
        off = getattr(var, "add_offset", None)
        if sf is not None or off is not None:
            data = data * np.float32(sf if sf is not None else 1.0) + \
                np.float32(off if off is not None else 0.0)
        return self._normalize_dims(data, var.dimensions)

    def _normalize_dims(self, data, dims):
        """Reorient a variable to (T, Y, X, E) by its OWN dim order.

        Dim roles come from _parse's resolved names (options override the
        autodetected candidates); singleton level axes are squeezed;
        missing roles become size-1 axes. Handles flipped y/x and
        interleaved orders (Testing/FileNetcdf.cpp dimNames)."""
        shape = data.shape
        t_ax = e_ax = y_ax = x_ax = None
        other = []
        for i, d in enumerate(dims):
            if d == self._tdim or (self._tdim is None
                                   and d in _TIME_NAMES):
                t_ax = i
            elif d == self._edim or (self._edim is None
                                     and d in _ENS_NAMES):
                e_ax = i
            elif d == self._ydim:
                y_ax = i
            elif d == self._xdim:
                x_ax = i
            else:
                other.append(i)
        # drop singleton unassigned axes (e.g. height0 levels)
        for i in other:
            if shape[i] == 1:
                data = np.squeeze(data, axis=i)
                dims = tuple(d for j, d in enumerate(dims) if j != i)
                return self._normalize_dims(data, dims)
        # leftover non-singleton axes fill any unassigned y then x slot
        if y_ax is None and other:
            y_ax = other.pop(0)
        if x_ax is None and other:
            x_ax = other.pop(0)
        perm = [a for a in (t_ax, y_ax, x_ax, e_ax) if a is not None]
        data = np.transpose(data, perm)
        pos = 0
        for role_ax in (t_ax, y_ax, x_ax, e_ax):
            if role_ax is None:
                data = np.expand_dims(data, axis=pos)
            pos += 1
        return data.astype(np.float32)

    def write(self, variables, history=""):
        """Write cached fields back (NetCDF3 via scipy).

        scipy's netcdf append mode corrupts record variables beyond the
        first record when assigned in place, so the file is rewritten
        wholesale: dimensions, attributes, and untouched variables are
        copied; cached fields replace their variables' data.
        """
        from scipy.io import netcdf_file
        updates = {}
        new_vars = []
        for name in variables:
            if name in self._fields and name in self._nc.variables:
                var = self._nc.variables[name]
                updates[name] = _fit_to_dims(self._fields[name], var.shape)
            elif name in self._fields:
                # NEW variable (e.g. `-vi old -v new` renames, diagnose
                # calibrators): created over the file's resolved
                # time/y/x[/ens] dims, like the reference's
                # initNewVariable (File/Netcdf.cpp, Testing/FileNetcdf
                # createNewVariable)
                new_vars.append(name)
        # Snapshot everything before closing the read handle. Attributes
        # come from the mutable _gattrs/_vattrs (set_attribute API).
        dims = dict(self._nc.dimensions)
        varspec = []
        for name, var in self._nc.variables.items():
            if name in updates:
                data = updates[name]
            elif var.shape == ():
                data = var.getValue()
            else:
                data = np.array(var[:])
            attrs = {k: (v.encode() if isinstance(v, str) else v)
                     for k, v in self._vattrs.get(name, {}).items()}
            varspec.append((name, var.dimensions, var.data.dtype, data,
                            attrs))
        def _pick_dim(size, prefer, used):
            """An existing dim of this size (preferring the resolved
            role dim), or a fresh one to create — new variables must
            never silently drop a non-singleton axis."""
            if prefer and prefer in dims and \
                    dims.get(prefer) in (None, size):
                return prefer
            for dn, sz in dims.items():
                if dn in used or dn in (self._tdim, self._edim):
                    continue
                if sz == size:
                    return dn
            dn = f"dim{size}"
            while dn in dims or dn in used:
                dn += "_"
            dims[dn] = size
            return dn

        for name in new_vars:
            field = self._fields[name]  # (T, Y, X, E)
            vdims = []
            data = field
            if field.shape[0] == 1 and not (
                    self._tdim in dims and
                    dims.get(self._tdim) in (None, 1)):
                data = data[0]
            else:
                vdims.append(_pick_dim(field.shape[0], self._tdim,
                                       set(vdims)))
            if field.shape[1] == 1 and self._ydim not in dims:
                data = np.squeeze(data, axis=-3)
            else:
                vdims.append(_pick_dim(field.shape[1], self._ydim,
                                       set(vdims)))
            if field.shape[2] == 1 and self._xdim not in dims:
                data = np.squeeze(data, axis=-2)
            else:
                vdims.append(_pick_dim(field.shape[2], self._xdim,
                                       set(vdims)))
            if field.shape[3] == 1:
                data = data[..., 0]
            else:
                vdims.append(_pick_dim(field.shape[3], self._edim,
                                       set(vdims)))
            varspec.append((name, tuple(vdims), np.dtype(np.float32),
                            np.ascontiguousarray(data, np.float32), {}))
            self._vattrs.setdefault(name, {})
        gattrs = {k: (v.encode() if isinstance(v, str) else v)
                  for k, v in self._gattrs.items()}
        self._nc.close()
        if history:
            prev = gattrs.get("history", b"")
            if isinstance(prev, bytes):
                prev = prev.decode()
            gattrs["history"] = (history + "\n" + prev).encode()
        out = netcdf_file(self.filename, "w", mmap=False)
        for key, value in gattrs.items():
            setattr(out, key, value)
        for name, size in dims.items():
            if size is None:
                # Materialize the unlimited (record) dimension: scipy's
                # writer mangles record-variable data, so emit fixed size.
                size = next((d.shape[i]
                             for _, vdims, _, d, _ in varspec
                             for i, dn in enumerate(vdims) if dn == name
                             and np.ndim(d) > i), 1)
            out.createDimension(name, int(size))
        for name, vdims, dtype, data, attrs in varspec:
            v = out.createVariable(name, dtype.newbyteorder("="), vdims)
            for key, value in attrs.items():
                setattr(v, key, value)
            if len(vdims) == 0:
                # assignValue is broken for 0-d backing arrays in scipy
                v.data[()] = data
            else:
                v[:] = np.asarray(data).astype(dtype)
        out.close()
        self._nc = netcdf_file(self.filename, "r", mmap=False)
        self._load_attrs()


def _read_rows(filename):
    """Non-comment whitespace rows of a text forecast file."""
    rows = []
    if not os.path.exists(filename):
        return rows
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    return rows


class FilePoint(File):
    """Single-location text forecasts (reference File/Point.cpp).

    Rows: unix time followed by one column per ensemble member. The
    location comes from required lat/lon/elev options; 'time' and 'ens'
    options size an empty (output-only) file.
    """

    def __init__(self, filename, options=None):
        super().__init__()
        self.filename = filename
        opt = options or Options()
        lat = opt.get_required("lat", float)
        lon = opt.get_required("lon", float)
        elev = opt.get_required("elev", float)
        if lat < -90 or lat > 90:
            raise RuntimeError(f"Invalid latitude: {lat}")
        self.grid = Grid(np.array([[lat]]), np.array([[lon]]),
                         np.array([[elev]]))
        rows = self._rows = _read_rows(filename)
        times = [r[0] for r in rows]
        num_ens = len(rows[0]) - 1 if rows else None
        if opt.has("ens"):
            num_ens = opt.get("ens", type=int)
        if opt.has("time"):
            times = list(range(opt.get("time", type=int)))
        if not times:
            raise RuntimeError(
                f"Missing 'time' option for empty file '{filename}'")
        if num_ens is None:
            raise RuntimeError(
                f"Missing 'ens' option for empty file '{filename}'")
        self.times = np.asarray(times, np.float64)
        self.num_ens = int(num_ens)

    def has_variable(self, name):
        return True

    def _read_field(self, name):
        field = np.full((len(self.times), 1, 1, self.num_ens), np.nan,
                        np.float32)
        for row, r in enumerate(self._rows):
            # Reference quirk preserved: the row's time column is matched
            # against the time INDEX, not the time value (Point.cpp:95-108)
            t_idx = int(r[0])
            if not 0 <= t_idx < len(self.times):
                continue
            if len(r) - 1 != self.num_ens:
                raise RuntimeError(
                    f"Row {row} in file '{self.filename}' has too many "
                    f"members (expecting {self.num_ens})")
            field[t_idx, 0, 0, :] = r[1:]
        return field

    def write(self, variables, history=""):
        if not variables:
            print("Warning: No variables to write")
            return
        field = self.get_field(variables[0])
        with open(self.filename, "w") as f:
            for i, t in enumerate(self.times):
                vals = " ".join(f"{v:.2f}" for v in field[i, 0, 0, :])
                f.write(f"{int(t)} {vals}\n")


class FileText(File):
    """Multi-location text forecasts (reference File/Text.cpp).

    Rows: `time lat lon elev ens0 [ens1 ...]`. Locations become a
    (L, 1) grid sorted by (lat, lon, elev), matching the reference's
    std::set<Location> ordering.
    """

    def __init__(self, filename, options=None):
        super().__init__()
        self.filename = filename
        rows = _read_rows(filename)
        num_ens = None
        values = {}
        locations = set()
        times = set()
        for r in rows:
            if len(r) < 5:
                raise RuntimeError(
                    f"Could not read value from file '{filename}'")
            t, lat, lon, elev = r[0], r[1], r[2], r[3]
            ens = r[4:]
            if num_ens is None:
                num_ens = len(ens)
            elif len(ens) != num_ens:
                raise RuntimeError(
                    f"File '{filename}' is corrupt, because it does not "
                    "have the same number of columns on each line")
            times.add(t)
            locations.add((lat, lon, elev))
            values[(t, (lat, lon, elev))] = ens
        self._locations = sorted(locations)
        self.times = np.asarray(sorted(times), np.float64)
        self.num_ens = num_ens if num_ens is not None else 1
        nl = max(len(self._locations), 1)
        lats = np.array([[loc[0]] for loc in self._locations]) \
            if self._locations else np.zeros((1, 1))
        lons = np.array([[loc[1]] for loc in self._locations]) \
            if self._locations else np.zeros((1, 1))
        elevs = np.array([[loc[2]] for loc in self._locations]) \
            if self._locations else np.zeros((1, 1))
        self.grid = Grid(lats, lons, elevs)
        field = np.full((max(len(self.times), 1), nl, 1, self.num_ens),
                        np.nan, np.float32)
        for (t, loc), ens in values.items():
            ti = int(np.nonzero(self.times == t)[0][0])
            li = self._locations.index(loc)
            field[ti, li, 0, :] = ens
        self._data = field

    def has_variable(self, name):
        return True

    def _read_field(self, name):
        return self._data.copy()

    def write(self, variables, history=""):
        # Reference quirk preserved: FileText::writeCore emits only
        # location (0, 0) per time (Text.cpp:131-150)
        if not variables:
            print("Warning: No variables to write")
            return
        field = self.get_field(variables[0])
        with open(self.filename, "w") as f:
            for i, t in enumerate(self.times):
                vals = " ".join(f"{v:.2f}" for v in field[i, 0, 0, :])
                f.write(f"{int(t)} {vals}\n")


class FileNorcomQnh(File):
    """NORCOM aviation QNH bulletin output (reference File/NorcomQnh.cpp).

    Write-only format: for each named station, the minimum QNH [Pa] over
    [startTime, endTime] is written as whole hPa in a FBNO52 bulletin.
    """

    def __init__(self, filename, options=None):
        super().__init__()
        self.filename = filename
        opt = options or Options()
        lats = opt.get_floats("lats")
        lons = opt.get_floats("lons")
        elevs = opt.get_floats("elevs")
        names = (opt.get("names") or "").split(",") if opt.has("names") \
            else []
        for key, vals in (("lats", lats), ("lons", lons),
                          ("elevs", elevs), ("names", names)):
            if not vals:
                raise RuntimeError(
                    f"Missing '{key}' option for '{filename}'")
        if not (len(lats) == len(lons) == len(elevs) == len(names)):
            raise RuntimeError("FileNorcomQnh: 'lats', 'lons', 'elevs', "
                               "'names' must be the same size")
        for lat in lats:
            if lat < -90 or lat > 90:
                raise RuntimeError(f"Invalid latitude: {lat}")
        num_times = opt.get("numTimes", type=int)
        if num_times is None:
            raise RuntimeError(
                f"Missing 'numTimes' option for '{filename}'")
        self.start_time = opt.get("startTime", type=int)
        self.end_time = opt.get("endTime", type=int)
        if self.start_time is None:
            raise RuntimeError(
                f"Missing 'startTime' option for '{filename}'")
        if self.end_time is None:
            raise RuntimeError(
                f"Missing 'endTime' option for '{filename}'")
        if self.start_time > self.end_time:
            raise RuntimeError(
                "FileNorcomQnh: 'startTime' must be <= 'endTime'")
        self.names = names
        self.grid = Grid(np.array([lats]), np.array([lons]),
                         np.array([elevs]))
        self.times = np.arange(num_times, dtype=np.float64)
        self.num_ens = 1

    def has_variable(self, name):
        return True

    def _read_field(self, name):
        return np.full((len(self.times), 1, len(self.names), 1), np.nan,
                       np.float32)

    @staticmethod
    def _norcom_stamp(unix_time) -> str:
        import time as _time
        tm = _time.gmtime(unix_time)
        return f"{tm.tm_mday:02d}{tm.tm_hour:02d}{tm.tm_min:02d}"

    def write(self, variables, history=""):
        import time as _time
        if not variables:
            print("Warning: No variables to write")
            return
        if len(variables) > 1:
            print("Warning: Output NorcomQnh can only write one variable, "
                  f"several given. Will write variable {variables[0]}")
        field = self.get_field(variables[0])
        width = max(len(n) for n in self.names)
        with open(self.filename, "w") as f:
            now = self._norcom_stamp(_time.time())
            start = self._norcom_stamp(self.times[self.start_time])
            end = self._norcom_stamp(self.times[self.end_time])
            f.write(f"FBNO52 ENNC {now}\r\r\n")
            f.write(f"VALID {start} - {end} UTC.\r\n")
            for j, name in enumerate(self.names):
                window = field[self.start_time:self.end_time + 1, 0, j, 0]
                valid = window[np.isfinite(window)]
                if valid.size == 0:
                    raise RuntimeError(
                        "Invalid value when writing QNH to NorcomQnh")
                hpa = int(valid.min()) // 100
                f.write(f"EST MIN QNH {name:<{width}}: {hpa:04d} HPA\r\n")


def _fit_to_dims(data, target_shape):
    """Reshape a (T, Y, X, E) field back to a variable's dim layout."""
    d = data
    if d.shape[-1] == 1 and len(target_shape) < 4:
        d = d[..., 0]
    try:
        return d.reshape(target_shape)
    except ValueError:
        flat = d.reshape(-1)
        need = int(np.prod(target_shape))
        return flat[:need].reshape(target_shape)


class FileFake(File):
    """Synthetic in-memory 10x10x2x10 file (File/Fake.cpp:2-50)."""

    def __init__(self, ny=10, nx=10, nt=2, ne=10):
        super().__init__()
        lats, lons = np.meshgrid(np.linspace(50, 60, ny),
                                 np.linspace(0, 10, nx), indexing="ij")
        elevs = np.zeros((ny, nx), np.float32)
        self.grid = Grid(lats, lons, elevs)
        self.times = np.arange(nt) * 3600.0
        self.num_ens = ne
        self._ny, self._nx, self._nt, self._ne = ny, nx, nt, ne

    def has_variable(self, name):
        return True

    def _read_field(self, name):
        t = np.arange(self._nt)[:, None, None, None]
        y = np.arange(self._ny)[None, :, None, None]
        x = np.arange(self._nx)[None, None, :, None]
        e = np.arange(self._ne)[None, None, None, :]
        return (y + x + 0.1 * e + t).astype(np.float32)

    def write(self, variables, history=""):
        pass
