"""Utility API functions (gridpp_tpu/api/utils.py, reference
src/api/util.cpp) that the neighbourhood API needs: numpy in and out, the
reference's NaN semantics, the reductions run on CPU tensors."""
from __future__ import annotations

import random

import numpy as np
import torch

from ..constants import MV, Statistic
from ..ops import stats as stats_ops

__all__ = ["calc_statistic", "calc_even_quantiles"]


def _rand_choice(arr):
    valid = arr[np.isfinite(arr)]
    if valid.size == 0:
        return np.float32(MV)
    return np.float32(valid[random.randrange(valid.size)])


def calc_statistic(array, statistic):
    """Statistic over a 1D vector, or per row over a 2D vector
    (util.cpp:19-110,209-216)."""
    array = np.asarray(array, dtype=np.float32)
    statistic = int(statistic)
    if array.ndim == 1:
        if statistic == Statistic.RandomChoice:
            return float(_rand_choice(array))
        if array.size == 0:
            return float(MV)
        out = stats_ops.nan_statistic(torch.from_numpy(array), statistic)
        return float(out)
    if array.ndim == 2:
        if statistic == Statistic.RandomChoice:
            return np.array([_rand_choice(row) for row in array], np.float32)
        if array.shape[1] == 0:
            return np.full(array.shape[0], MV, np.float32)
        out = stats_ops.nan_statistic(torch.from_numpy(array), statistic)
        return out.numpy()
    raise ValueError("array must be 1D or 2D")


def calc_even_quantiles(values, num):
    """Evenly spaced quantile thresholds from data, dedup-aware
    (util.cpp:261-375)."""
    values = np.asarray(values, dtype=np.float32)
    num = int(num)
    size = values.size
    if num == 0 or size == 0:
        return np.zeros(0, np.float32)
    sorted_v = np.sort(values)
    if num >= size:
        return np.unique(sorted_v).astype(np.float32)  # all unique values
    lowest = sorted_v[0]
    highest = sorted_v[-1]
    count_lower = int(np.searchsorted(sorted_v, lowest, side="right"))
    quantiles = [lowest]
    if num == 2:
        if lowest != highest:
            quantiles.append(highest)
        return np.asarray(quantiles, np.float32)
    repeated_at_beginning = count_lower < size and count_lower > size // num
    if repeated_at_beginning:
        quantiles.append(sorted_v[count_lower])
    last_added = quantiles[-1]
    remaining = np.unique(sorted_v[sorted_v > last_added])
    if remaining.size > 0:
        num_left = num - len(quantiles)
        for i in range(1, num_left + 1):
            f = float(i) / num_left
            index = int(remaining.size * f) - 1
            if index >= 0:
                quantiles.append(remaining[index])
            else:
                raise RuntimeError("Internal error in calc_even_quantiles.")
    return np.asarray(quantiles, np.float32)
