"""Kernel K1: the NaN-skipping windowed Mean / Sum / Count stencil.

`neighbourhood_mean_cuda` launches the hand-written CUDA kernel
(csrc/neighbourhood_mean.cu, which replaces
gridpp_tpu/ops/pallas_stencil.py::_mean_kernel) on a CUDA tensor.
`neighbourhood_mean_plain` is the same function in plain PyTorch: the CPU
path, and the reference the kernel is held to on the card.
ops/neighbourhood.py picks one by where the tensor lies.

Both take x of shape (Y, X) or (B, Y, X), f32, and halfwidths already
clipped to the grid (hy <= Y - 1, hx <= X - 1); the leading axis is a batch
of independent planes.
"""
from __future__ import annotations

import ctypes
import os
import shutil

import torch

from .._build import build_shared
from ..constants import Statistic

__all__ = ["neighbourhood_mean_cuda", "neighbourhood_mean_plain",
           "build_kernel", "STATS"]

STATS = (int(Statistic.Mean), int(Statistic.Sum), int(Statistic.Count))

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "neighbourhood_mean.cu")
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_kernel() -> str:
    """Compile the kernel for sm_90a (at first use) and return the
    library's path. Raises when the build fails."""
    nvcc = _nvcc()
    return build_shared(
        "neighbourhood_mean", [_SRC],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                     "-Xcompiler", "-fPIC", "-o", out, _SRC])


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_kernel())
        lib.nbm_launch.restype = ctypes.c_int
        lib.nbm_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.nbm_smem_bytes.restype = ctypes.c_size_t
        lib.nbm_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.nbm_smem_limit.restype = ctypes.c_int
        lib.nbm_smem_limit.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check_args(x, hy, hx, stat):
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"expected (Y, X) or (B, Y, X), got {tuple(x.shape)}")
    if stat not in STATS:
        raise ValueError(f"statistic {stat} is not Mean, Sum or Count")
    ny, nx = x.shape[-2:]
    if not (0 <= hy <= max(ny - 1, 0) and 0 <= hx <= max(nx - 1, 0)):
        raise ValueError(f"halfwidths ({hy}, {hx}) not clipped to the grid "
                         f"({ny}, {nx})")


def neighbourhood_mean_cuda(x: torch.Tensor, hy: int, hx: int,
                            stat: int) -> torch.Tensor:
    """Launch K1 on a CUDA tensor; returns a new tensor of x's shape."""
    stat = int(stat)
    _check_args(x, hy, hx, stat)
    if not x.is_cuda:
        raise ValueError("neighbourhood_mean_cuda needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("neighbourhood_mean_cuda needs a contiguous tensor")
    lib = _load()
    dev = x.device.index
    need = lib.nbm_smem_bytes(hy, hx)
    limit = lib.nbm_smem_limit(dev)
    if need > limit:
        raise ValueError(f"halfwidths ({hy}, {hx}) need {need} bytes of "
                         f"shared memory; the device allows {limit}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b = x.shape[0] if x.dim() == 3 else 1
    ny, nx = x.shape[-2:]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.nbm_launch(x.data_ptr(), out.data_ptr(), b, ny, nx, hy, hx,
                         stat, dev, stream)
    if err != 0:
        raise RuntimeError(f"neighbourhood_mean kernel launch failed: "
                           f"cudaError {err}")
    neighbourhood_mean_cuda.launches += 1
    return out


neighbourhood_mean_cuda.launches = 0


def neighbourhood_mean_plain(x: torch.Tensor, hy: int, hx: int,
                             stat: int) -> torch.Tensor:
    """K1 in plain PyTorch: direct window sums of a NaN-zeroed copy and a
    validity mask, vertical pass then horizontal pass (unfold + sum; no
    convolution, which would run in TF32 through cuDNN)."""
    stat = int(stat)
    _check_args(x, hy, hx, stat)
    valid = torch.isfinite(x)
    s = torch.where(valid, x, 0.0)
    c = valid.to(torch.float32)

    def window(v):
        v = torch.nn.functional.pad(v, (0, 0, hy, hy))
        v = v.unfold(-2, 2 * hy + 1, 1).sum(-1)
        v = torch.nn.functional.pad(v, (hx, hx))
        return v.unfold(-1, 2 * hx + 1, 1).sum(-1)

    s = window(s)
    c = window(c)
    if stat == int(Statistic.Count):
        return c
    val = s / torch.clamp(c, min=1.0) if stat == int(Statistic.Mean) else s
    return torch.where(c > 0, val, torch.nan)

