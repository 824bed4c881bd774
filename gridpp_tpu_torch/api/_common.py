"""Shared helpers of the numpy API layer (gridpp_tpu/api/_common.py).

The reference maps std::invalid_argument to Python ValueError through SWIG
(reference swig/gridpp.i:21-40); the API functions raise ValueError with the
same messages.

Where an API function runs is torch's default device, read once per call
(`api_device`): the CPU is the host route (gridpp's numpy-in/numpy-out
contract, with the native C++ solvers), any other device the device route.
The top-level package pins its public API functions to the host
(`pin_host`), as gridpp_tpu pins them to its XLA:CPU backend; the device
route is reached by calling the module function unpinned under that
device, e.g. `with torch.device("cuda"):
gridpp_tpu_torch.api.oi.optimal_interpolation(...)`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def asarray_f32(x, name="values"):
    try:
        arr = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"Could not convert {name} to a float array: {e}")
    return arr


def api_device() -> torch.device:
    """The device an API call runs on: torch's default device."""
    return torch.get_default_device()


def on_host() -> bool:
    """True when the API runs on the host CPU (pinned, or the CPU is the
    default device anyway)."""
    return api_device().type == "cpu"


def pin_host(fn):
    """Run an API function with the CPU as torch's default device.

    The numpy API's contract is host memory, like the reference's SWIG
    bindings, so the top-level functions run their ops on the host; the
    device route is the module function called under another device."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.device("cpu"):
            return fn(*args, **kwargs)

    wrapper.__wrapped_host_pin__ = True
    return wrapper
