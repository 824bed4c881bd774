"""The serving stream's host staging: copy and finiteness check in one pass.

`csrc/host_stage.cpp` (this package's own csrc/, not the repository's
shared one), compiled with g++ -fopenmp on first use (see _build.py) and
called through ctypes, which releases the GIL for the call. `stage(arrays,
bufs)` copies each float32 array into its pinned staging buffer bit for
bit and says whether every value was finite, on up to
`torch.get_num_threads()` of torch's own OpenMP threads: each byte is read
once, where a finiteness pass and then torch's copy read it twice. A build
that fails raises, as the card's other libraries do: nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .._build import build_shared
from ..tracing import count

__all__ = ["get_lib", "as_f32", "stage"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host_stage.cpp")


@functools.cache
def get_lib():
    """The staging library, built at first use. Raises when the build
    fails (subprocess.CalledProcessError, or OSError without g++)."""
    lib = ctypes.CDLL(build_shared(
        "host_stage", [_SRC],
        lambda out: ["g++", "-O3", "-std=c++17", "-fopenmp", "-shared",
                     "-fPIC", "-o", out, _SRC], timeout=120))
    lib.stage_f32.restype = ctypes.c_int
    lib.stage_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int]
    return lib


def as_f32(arrays) -> list:
    """Each array as a C-contiguous float32 numpy array of its shape: itself
    where it is one, else np.asarray's float32 values, made contiguous
    (counted as `serve.stage.converted`)."""
    out = []
    for a in arrays:
        f = np.asarray(a, np.float32)
        if not f.flags.c_contiguous:
            f = np.ascontiguousarray(f)
        if f is not a:
            count("serve.stage.converted")
        out.append(f)
    return out


def stage(arrays, bufs) -> bool:
    """Copy each C-contiguous float32 array into its buffer (a contiguous
    float32 CPU tensor of as many elements) bit for bit; whether every
    value was finite. Every value is copied whatever the answer. Counts
    `serve.stage.fused` for each array staged."""
    for a, buf in zip(arrays, bufs, strict=True):
        if not (a.dtype == np.float32 and a.flags.c_contiguous):
            raise ValueError("stage takes C-contiguous float32 arrays")
        if not (buf.dtype == torch.float32 and buf.device.type == "cpu"
                and buf.is_contiguous() and buf.numel() == a.size):
            raise ValueError(f"a staging buffer of {a.size} contiguous "
                             f"float32 elements on the CPU is needed, not "
                             f"{buf.dtype} {tuple(buf.shape)} on "
                             f"{buf.device}")
    lib, threads = get_lib(), torch.get_num_threads()
    bad = 0
    for a, buf in zip(arrays, bufs):
        bad |= lib.stage_f32(a.ctypes.data, buf.data_ptr(), a.size, threads)
        count("serve.stage.fused")
    return bad == 0
