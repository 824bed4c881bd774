"""Shared helpers of the numpy API layer (gridpp_tpu/api/_common.py).

The reference maps std::invalid_argument to Python ValueError through SWIG
(reference swig/gridpp.i:21-40); the API functions raise ValueError with the
same messages.
"""
from __future__ import annotations

import numpy as np


def asarray_f32(x, name="values"):
    try:
        arr = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"Could not convert {name} to a float array: {e}")
    return arr
