"""Shared helpers of the numpy API layer (gridpp_tpu/api/_common.py).

The reference maps std::invalid_argument to Python ValueError through SWIG
(reference swig/gridpp.i:21-40); the API functions raise ValueError with the
same messages.

Where an API function runs is read once per call (`api_device`): the CPU
is the host route (gridpp's numpy-in/numpy-out contract, with the native
C++ solvers), any other device the device route. The top-level package
pins its public API functions to the host (`pin_host`), as gridpp_tpu pins
them to its XLA:CPU backend. A module function called unpinned runs on the
card when there is one, as gridpp_tpu's run on jax's default backend, e.g.
`gridpp_tpu_torch.api.oi.optimal_interpolation(...)`; under another
default device than the CPU (`with torch.device("cuda:1"):`) it runs
there, and under `host()` on the CPU.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import numpy as np
import torch


def asarray_f32(x, name="values"):
    try:
        arr = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"Could not convert {name} to a float array: {e}")
    return arr


def upload(values: np.ndarray, dev) -> torch.Tensor:
    """A numpy array as a tensor on dev (no copy on the CPU)."""
    return torch.as_tensor(np.require(values, requirements="W"), device=dev)


def check_grid_compatible(grid, values):
    """compatible_size(Grid, vec2/vec3) (util.cpp:434-444); values is an
    array or a tensor."""
    if int(np.prod(values.shape)) == 0:
        return
    if tuple(values.shape[-2:]) != tuple(grid.size()):
        raise ValueError("Grid size is not the same as values")


def check_points_compatible(points, values):
    if points.size() != values.shape[-1]:
        raise ValueError("Points size is not the same as values")


_HOST = contextvars.ContextVar("gridpp_tpu_torch_host", default=False)


@contextlib.contextmanager
def host():
    """Run the API calls inside on the host CPU, with the CPU as torch's
    default device."""
    token = _HOST.set(True)
    try:
        with torch.device("cpu"):
            yield
    finally:
        _HOST.reset(token)


def api_device() -> torch.device:
    """The device an API call runs on: the CPU inside `host()`; else
    torch's default device, or the current card when that default is the
    CPU and a card is present."""
    if _HOST.get():
        return torch.device("cpu")
    dev = torch.get_default_device()
    if dev.type == "cpu" and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def on_host() -> bool:
    """True when the API runs on the host CPU (pinned, or no card)."""
    return api_device().type == "cpu"


def pin_host(fn):
    """Run an API function on the host CPU (`host()`).

    The numpy API's contract is host memory, like the reference's SWIG
    bindings, so the top-level functions run their ops on the host; the
    device route is the module function called unpinned."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with host():
            return fn(*args, **kwargs)

    wrapper.__wrapped_host_pin__ = True
    return wrapper
