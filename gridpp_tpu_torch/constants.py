"""Constants and enums for gridpp_tpu_torch (a copy of gridpp_tpu.constants).

Mirrors the reference constant/enum surface (reference include/gridpp.h:43-146)
so that user code written against gridpp's Python bindings ports unchanged.
Enums use the same integer codes as the reference so serialized configs stay
compatible.
"""
from __future__ import annotations

import enum

import numpy as np

__version__ = "0.1.0"

# Missing value indicator (reference gridpp.h:49 `MV = NAN`)
MV = float("nan")
# Missing value indicator used by the command-line tool (gridpp.h:51)
MV_CML = -999.0
pi = 3.14159265
# Radius of the earth [m] (gridpp.h:55)
radius_earth = 6.378137e6
# Moist-air standard atmosphere lapse rate [K/m] (gridpp.h:57)
lapse_rate = 0.0065
# Temperature at surface in standard atmosphere [K] (gridpp.h:59)
standard_surface_temperature = 288.15
# Gravitational acceleration [m/s^2] (gridpp.h:61)
gravit = 9.80665
# Molar mass of dry air [kg/mol] (gridpp.h:63)
molar_mass = 0.0289644
# Universal gas constant [kg*m^2*s^-2/(K*mol)] (gridpp.h:65)
gas_constant_mol = 8.31447
# Specific gas constant for dry air [J/(kg*K)] (gridpp.h:67)
gas_constant_si = 287.05

swig_default_value = -1.0


class Extrapolation(enum.IntEnum):
    """Methods for extrapolating outside a curve (gridpp.h:79-86)."""

    OneToOne = 0
    MeanSlope = 10
    NearestSlope = 20
    Zero = 30
    Unchanged = 40


class Statistic(enum.IntEnum):
    """Statistical reductions (gridpp.h:89-101)."""

    Mean = 0
    Min = 10
    Median = 20
    Max = 30
    Quantile = 40
    Std = 50
    Variance = 60
    Sum = 70
    Count = 80
    RandomChoice = 90
    Unknown = -1


class Metric(enum.IntEnum):
    """Binary verification metrics (gridpp.h:104-111)."""

    Ets = 0
    Ts = 1
    Kss = 20
    Pc = 30
    Bias = 40
    Hss = 50


class CorrectionType(enum.IntEnum):
    """Method for statistical correction (gridpp.h:114-118)."""

    Qq = 0
    Multiplicative = 10
    Additive = 20


class CoordinateType(enum.IntEnum):
    """Coordinate systems for point positions (gridpp.h:121-124)."""

    Geodetic = 0
    Cartesian = 1


class GradientType(enum.IntEnum):
    """Methods to calculate a gradient (gridpp.h:127-130)."""

    MinMax = 0
    LinearRegression = 10


class Downscaler(enum.IntEnum):
    """Simple downscaling methods (gridpp.h:133-136)."""

    Nearest = 0
    Bilinear = 1


class ComparisonOperator(enum.IntEnum):
    """Comparison operators (gridpp.h:139-144)."""

    Lt = 0
    Leq = 10
    Gt = 20
    Geq = 30


# Module-level aliases so `gridpp.Mean`-style access works like the bindings.
OneToOne = Extrapolation.OneToOne
MeanSlope = Extrapolation.MeanSlope
NearestSlope = Extrapolation.NearestSlope
Zero = Extrapolation.Zero
Unchanged = Extrapolation.Unchanged

Mean = Statistic.Mean
Min = Statistic.Min
Median = Statistic.Median
Max = Statistic.Max
Quantile = Statistic.Quantile
Std = Statistic.Std
Variance = Statistic.Variance
Sum = Statistic.Sum
Count = Statistic.Count
RandomChoice = Statistic.RandomChoice
Unknown = Statistic.Unknown

Ets = Metric.Ets
Ts = Metric.Ts
Kss = Metric.Kss
Pc = Metric.Pc
Bias = Metric.Bias
Hss = Metric.Hss

Qq = CorrectionType.Qq
Multiplicative = CorrectionType.Multiplicative
Additive = CorrectionType.Additive

Geodetic = CoordinateType.Geodetic
Cartesian = CoordinateType.Cartesian

MinMax = GradientType.MinMax
LinearRegression = GradientType.LinearRegression

Nearest = Downscaler.Nearest
Bilinear = Downscaler.Bilinear

Lt = ComparisonOperator.Lt
Leq = ComparisonOperator.Leq
Gt = ComparisonOperator.Gt
Geq = ComparisonOperator.Geq


_STATISTIC_NAMES = {
    "mean": Statistic.Mean,
    "min": Statistic.Min,
    "median": Statistic.Median,
    "max": Statistic.Max,
    "quantile": Statistic.Quantile,
    "std": Statistic.Std,
    "variance": Statistic.Variance,
    "sum": Statistic.Sum,
    "count": Statistic.Count,
    "randomchoice": Statistic.RandomChoice,
}


def get_statistic(name: str) -> Statistic:
    """Convert a statistic name to the enum (reference gridpp.cpp:10-25)."""
    return _STATISTIC_NAMES.get(name, Statistic.Unknown)


def version() -> str:
    return __version__


def is_valid(value) -> bool:
    """True when value is not NaN/Inf (reference util.cpp:16-18)."""
    value = np.asarray(value)
    return bool(np.all(np.isfinite(value)))
