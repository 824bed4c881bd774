"""window API (gridpp_tpu/api/window_api.py; reference src/api/window.cpp).

On the host, Mean, Sum and Count take the native running window (csrc
window_run), as gridpp_tpu's do; every other statistic, and every
statistic on the card, runs ops/window.py on the API's device
(api/_common.api_device).
"""
from __future__ import annotations

import numpy as np

from ..constants import Statistic
from ..ops.window import window as window_op
from .. import native
from ._common import api_device, asarray_f32, on_host, upload

__all__ = ["window"]


def window(array, length, statistic, before=False, keep_missing=False,
           missing_edges=True):
    """Running statistic along time for each case row (window.cpp:6-156).

    array: (Case, Time). Centred windows require an odd length unless
    `before` (a trailing window) is set.
    """
    if length <= 0:
        raise ValueError("Length variable must be > 0")
    array = asarray_f32(array)
    if array.ndim != 2:
        raise ValueError("array must be 2D")
    if array.size == 0:
        # Reference: zero case rows collapse to (0, 0); zero time columns
        # keep their shape (window.cpp via tests test_no_cases/no_times)
        if array.shape[0] == 0:
            return np.zeros((0, 0), np.float32)
        return np.zeros(array.shape, np.float32)
    if length % 2 == 0 and not before:
        raise ValueError("Length variable must be an odd number")
    statistic = int(statistic)
    if on_host() and statistic in (Statistic.Mean, Statistic.Sum,
                                   Statistic.Count):
        out = native.window_run(array, int(length), statistic, bool(before),
                                bool(keep_missing), bool(missing_edges))
        if out is not None:
            return out
    out = window_op(upload(array, api_device()), int(length), statistic,
                    bool(before), bool(keep_missing), bool(missing_edges))
    return out.cpu().numpy()
