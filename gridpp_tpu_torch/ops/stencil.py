"""The neighbourhood stencil kernels K1-K5 and their plain versions.

Each kernel is CUDA C++ for sm_90a under csrc/, built with nvcc into its own
shared library at first use (one library per source, so the builds can run
in parallel, as chip_smoke.py runs them) and bound with ctypes:

  K1 neighbourhood_mean_cuda           csrc/neighbourhood_mean.cu
     replaces gridpp_tpu/ops/pallas_stencil.py::_mean_kernel
  K2 neighbourhood_minmax_cuda         csrc/neighbourhood_minmax.cu
     replaces ::_minmax_kernel
  K3 neighbourhood_var_cuda            csrc/neighbourhood_var.cu
     replaces ::_var_kernel
  K4 neighbourhood_quantile_fast_cuda  csrc/neighbourhood_quantile_fast.cu
     replaces ::_qf_kernel
  K5 neighbourhood_members_cuda        csrc/neighbourhood_members.cu
     replaces ::_member_mean_kernel and ::_member_minmax_kernel

A `*_cuda` wrapper takes only a CUDA tensor and launches its kernel, or
raises; it counts its launches in `<wrapper>.launches`. Beside each sits its
plain PyTorch version (`*_plain`; K4's is
ops/neighbourhood.py::_quantile_fast_xla): the CPU path, and the reference
the kernel is held to on the card. ops/neighbourhood.py picks one by where
the tensor lies; `neighbourhood_members` does so here. K4 and K5 take a
launch plan (`qf_plan`, `member_plan`) worked out here, in Python, so that
the CPU tests reach it.

The stencils take x of shape (Y, X) or (B, Y, X), f32, and halfwidths
already clipped to the grid (hy <= Y - 1, hx <= X - 1); a leading axis is a
batch of independent planes.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._build import build_shared
from ..constants import Statistic

__all__ = [
    "KERNELS", "build_kernel", "single_cell",
    "MEAN_STATS", "MINMAX_STATS", "VAR_STATS", "MEMBER_STATS",
    "neighbourhood_mean_cuda", "neighbourhood_mean_plain",
    "neighbourhood_minmax_cuda", "neighbourhood_minmax_plain",
    "neighbourhood_var_cuda", "neighbourhood_var_plain",
    "neighbourhood_quantile_fast_cuda", "qf_lane_bits", "qf_words",
    "qf_plan",
    "member_plan", "neighbourhood_members", "neighbourhood_members_cuda",
    "neighbourhood_members_plain",
]

MEAN_STATS = (int(Statistic.Mean), int(Statistic.Sum), int(Statistic.Count))
MINMAX_STATS = (int(Statistic.Min), int(Statistic.Max))
VAR_STATS = (int(Statistic.Std), int(Statistic.Variance))
MEMBER_STATS = MEAN_STATS + MINMAX_STATS

# kernel source name -> its C launch function
KERNELS = {"neighbourhood_mean": "nbm_launch",
           "neighbourhood_minmax": "nbx_launch",
           "neighbourhood_var": "nbv_launch",
           "neighbourhood_quantile_fast": "nbq_launch",
           "neighbourhood_members": "nbk_launch"}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_HEADER = os.path.join(_CSRC, "stencil_tile.cuh")
_c_p, _c_i = ctypes.c_void_p, ctypes.c_int
# nbm_launch, nbx_launch and nbv_launch share one signature
_STENCIL_ARGS = [_c_p, _c_p] + [_c_i] * 6 + [_c_i, _c_p]
_ARGTYPES = {"nbm_launch": _STENCIL_ARGS, "nbx_launch": _STENCIL_ARGS,
             "nbv_launch": _STENCIL_ARGS,
             "nbq_launch": [_c_p, _c_p, _c_i, _c_p, _c_p] + [_c_i] * 8
             + [_c_i, _c_p],
             "nbk_launch": [_c_p, _c_p] + [_c_i] * 9 + [_c_i, _c_p]}
_libs: dict = {}

# the dynamic shared memory one block may opt in to on an H100 (232,448
# bytes); the launch functions check the device's own limit again
SMEM_LIMIT = 232448
# K4's output patch (kBY x kBX, csrc/stencil_tile.cuh)
QF_BY, QF_BX = 32, 64
# K5's output rows per block (kRows, csrc/neighbourhood_members.cu) and
# the tile row width it aims at, in floats
K5_ROWS, K5_WIDTH = 16, 480


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


def build_kernel(name: str) -> str:
    """Compile csrc/<name>.cu for sm_90a (at first use) and return the
    library's path. Raises when the build fails."""
    if name not in KERNELS:
        raise ValueError(f"no kernel source {name!r}")
    src = os.path.join(_CSRC, f"{name}.cu")
    nvcc = _nvcc()
    return build_shared(
        name, [src, _HEADER],
        lambda out: [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                     "-Xcompiler", "-fPIC", "-o", out, src])


def _launcher(name: str):
    if name not in _libs:
        lib = ctypes.CDLL(build_kernel(name))
        fn = getattr(lib, KERNELS[name])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[KERNELS[name]]
        _libs[name] = fn
    return _libs[name]


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Call csrc/<name>.cu's launch function with x's device and current
    stream appended; raise on any code but 0."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher(name)(*args, x.device.index, stream)
    if err == -1:
        raise ValueError(f"{name}: the halfwidths need more shared memory "
                         "than the device gives one block")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err}")


def _check_args(x, hy, hx, stat=None, stats=(), what=""):
    """x is (Y, X) or (B, Y, X) f32 with clipped halfwidths; stat, when
    given, is one of `stats`."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"expected (Y, X) or (B, Y, X), got {tuple(x.shape)}")
    if stat is not None and stat not in stats:
        raise ValueError(f"statistic {stat} is not {what}")
    ny, nx = x.shape[-2:]
    if not (0 <= hy <= max(ny - 1, 0) and 0 <= hx <= max(nx - 1, 0)):
        raise ValueError(f"halfwidths ({hy}, {hx}) not clipped to the grid "
                         f"({ny}, {nx})")


def _check_cuda(x, fn):
    if not x.is_cuda:
        raise ValueError(f"{fn} needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError(f"{fn} needs a contiguous tensor")


def _plane_stencil(name, wrapper, x, hy, hx, stat):
    """Launch K1/K2/K3 on the contiguous planes of x; returns a new tensor
    of x's shape."""
    _check_cuda(x, wrapper.__name__)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b = x.shape[0] if x.dim() == 3 else 1
    ny, nx = x.shape[-2:]
    _launch(name, x, x.data_ptr(), out.data_ptr(), b, ny, nx, hy, hx, stat)
    wrapper.launches += 1
    return out


def single_cell(x: torch.Tensor, stat: int) -> torch.Tensor:
    """Any stencil statistic over a window of one cell (halfwidth 0), which
    launches no kernel: Count is the validity, Std/Variance are 0 where the
    cell is finite, the others the value; NaN where it is not finite (the
    Pallas kernels' h=0 rules, gridpp_tpu/ops/pallas_stencil.py:422-443)."""
    valid = torch.isfinite(x)
    if int(stat) == int(Statistic.Count):
        return valid.to(torch.float32)
    if int(stat) in VAR_STATS:
        return torch.where(valid, 0.0, torch.nan)
    return torch.where(valid, x, torch.nan)


def _window(v, hy, hx, reduce, fill):
    """Separable (2hy+1) x (2hx+1) window reduction over the last two axes,
    padded with `fill`: vertical pass, then horizontal (unfold + reduce; no
    convolution, which would run in TF32 through cuDNN)."""
    v = F.pad(v, (0, 0, hy, hy), value=fill)
    v = reduce(v.unfold(-2, 2 * hy + 1, 1), -1)
    v = F.pad(v, (hx, hx), value=fill)
    return reduce(v.unfold(-1, 2 * hx + 1, 1), -1)


# -- K1: Mean / Sum / Count ---------------------------------------------------
def neighbourhood_mean_cuda(x: torch.Tensor, hy: int, hx: int,
                            stat: int) -> torch.Tensor:
    """Launch K1 on a CUDA tensor; returns a new tensor of x's shape."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, MEAN_STATS, "Mean, Sum or Count")
    return _plane_stencil("neighbourhood_mean", neighbourhood_mean_cuda, x,
                          hy, hx, stat)


neighbourhood_mean_cuda.launches = 0


def neighbourhood_mean_plain(x: torch.Tensor, hy: int, hx: int,
                             stat: int) -> torch.Tensor:
    """K1 in plain PyTorch: direct window sums of a NaN-zeroed copy and a
    validity mask."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, MEAN_STATS, "Mean, Sum or Count")
    valid = torch.isfinite(x)
    s = _window(torch.where(valid, x, 0.0), hy, hx, torch.sum, 0.0)
    c = _window(valid.to(torch.float32), hy, hx, torch.sum, 0.0)
    if stat == int(Statistic.Count):
        return c
    val = s / torch.clamp(c, min=1.0) if stat == int(Statistic.Mean) else s
    return torch.where(c > 0, val, torch.nan)


# -- K2: Min / Max ------------------------------------------------------------
def neighbourhood_minmax_cuda(x: torch.Tensor, hy: int, hx: int,
                              stat: int) -> torch.Tensor:
    """Launch K2 on a CUDA tensor; returns a new tensor of x's shape."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, MINMAX_STATS, "Min or Max")
    return _plane_stencil("neighbourhood_minmax", neighbourhood_minmax_cuda,
                          x, hy, hx, stat)


neighbourhood_minmax_cuda.launches = 0


def neighbourhood_minmax_plain(x: torch.Tensor, hy: int, hx: int,
                               stat: int) -> torch.Tensor:
    """K2 in plain PyTorch: non-finite cells read as the identity (+inf for
    Min, -inf for Max); a window left at the identity gives NaN."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, MINMAX_STATS, "Min or Max")
    if stat == int(Statistic.Max):
        ident, reduce = -torch.inf, torch.amax
    else:
        ident, reduce = torch.inf, torch.amin
    ext = _window(torch.where(torch.isfinite(x), x, ident), hy, hx, reduce,
                  ident)
    return torch.where(torch.isfinite(ext), ext, torch.nan)


# -- K3: Std / Variance -------------------------------------------------------
def neighbourhood_var_cuda(x: torch.Tensor, hy: int, hx: int,
                           stat: int) -> torch.Tensor:
    """Launch K3 on a CUDA tensor; returns a new tensor of x's shape."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, VAR_STATS, "Std or Variance")
    return _plane_stencil("neighbourhood_var", neighbourhood_var_cuda, x, hy,
                          hx, stat)


neighbourhood_var_cuda.launches = 0


def neighbourhood_var_plain(x: torch.Tensor, hy: int, hx: int,
                            stat: int) -> torch.Tensor:
    """K3 in plain PyTorch: gridpp_tpu's two-pass `_xla_basic` form,
    E[x^2] - E[x]^2 from two Mean stencils, unclamped."""
    stat = int(stat)
    _check_args(x, hy, hx, stat, VAR_STATS, "Std or Variance")
    mean = neighbourhood_mean_plain(x, hy, hx, int(Statistic.Mean))
    mean2 = neighbourhood_mean_plain(x * x, hy, hx, int(Statistic.Mean))
    var = mean2 - mean * mean  # unclamped, like neighbourhood.cpp:211-235
    return torch.sqrt(var) if stat == int(Statistic.Std) else var


# -- K4: threshold-CDF quantile -----------------------------------------------
def qf_lane_bits(window_cells: int) -> int:
    """Width in bits of one packed count lane of K4 for a window of
    `window_cells` cells: a lane must hold counts up to the window size, so
    8 bits while it is <= 255, 16 while <= 65535, else 32 (one count per
    int32 word). gridpp_tpu/ops/pallas_stencil.py:510-512 packs the same."""
    if window_cells <= 255:
        return 8
    if window_cells <= 65535:
        return 16
    return 32


def qf_words(t: int, bits: int) -> int:
    """Packed int32 words a cell of K4 needs for t thresholds in `bits`-wide
    lanes: lane 0 counts the finite cells, lane k + 1 threshold k."""
    return -(-(t + 1) // (32 // bits))


class QfPlan(NamedTuple):
    """K4's launch plan: `bits`-wide lanes, `words` packed words a cell,
    `group` words summed together (1, 2 or 4; one pass where group >=
    words), `pitch` of the vertical sums, `smem` bytes."""
    bits: int
    words: int
    group: int
    pitch: int
    smem: int


def qf_plan(hy: int, hx: int, t: int) -> QfPlan:
    """K4's plan for clipped halfwidths (hy, hx) and t thresholds. The
    block's halo tile (kBY + 2hy) x (kBX + 2hx) floats takes shared memory
    beside `group` planes of kBY x pitch vertical sums; the plan takes the
    one pass over the fewest words that hold all of a cell's counts, else
    the largest group that fits, and an odd pitch (free of bank conflicts)
    where it fits. Raises a "shared memory" ValueError where not even one
    word a group fits; that takes every halfwidth a per-threshold count
    with one plane of vertical counts takes."""
    bits = qf_lane_bits((2 * hy + 1) * (2 * hx + 1))
    words = qf_words(t, bits)
    tw = QF_BX + 2 * hx
    # the tile, which the staged outputs (QF_BY x (QF_BX + 1)) overwrite
    tile = max((QF_BY + 2 * hy) * tw, QF_BY * (QF_BX + 1))
    for pitch in (tw | 1, tw):
        groups = [g for g in (1, 2, 4) if g >= words] + [4, 2, 1]
        for group in groups:
            smem = 4 * (tile + group * QF_BY * pitch)
            if smem <= SMEM_LIMIT:
                return QfPlan(bits, words, group, pitch, smem)
    raise ValueError(f"neighbourhood_quantile_fast: halfwidths ({hy}, {hx}) "
                     "need more shared memory than the device gives one "
                     "block")


def neighbourhood_quantile_fast_cuda(x: torch.Tensor, quantile, hy: int,
                                     hx: int, thresholds: torch.Tensor
                                     ) -> torch.Tensor:
    """Launch K4 on a (Y, X) CUDA tensor with a scalar quantile (a number
    or a one-element tensor) and (T,) thresholds; returns (Y, X). A
    non-finite quantile gives NaN everywhere."""
    _check_args(x, hy, hx)
    if x.dim() != 2:
        raise ValueError(f"expected (Y, X), got {tuple(x.shape)}")
    _check_cuda(x, "neighbourhood_quantile_fast_cuda")
    thr = torch.as_tensor(thresholds, device=x.device)
    if thr.dtype != torch.float32 or thr.dim() != 1 or thr.numel() == 0:
        raise ValueError("thresholds must be a non-empty (T,) float32 tensor")
    q = torch.as_tensor(quantile, dtype=torch.float32, device=x.device)
    if q.numel() != 1:
        raise ValueError("quantile must be a scalar")
    thr, q = thr.contiguous(), q.reshape(1)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ny, nx = x.shape
    plan = qf_plan(hy, hx, thr.numel())
    _launch("neighbourhood_quantile_fast", x, x.data_ptr(), thr.data_ptr(),
            thr.numel(), q.data_ptr(), out.data_ptr(), ny, nx, hy, hx,
            plan.bits, plan.words, plan.group, plan.pitch)
    neighbourhood_quantile_fast_cuda.launches += 1
    return out


neighbourhood_quantile_fast_cuda.launches = 0


# -- K5: every member of a (Y, X, E) field at once ----------------------------
def neighbourhood_members(x: torch.Tensor, halfwidth: int,
                          statistic: int) -> torch.Tensor:
    """Windowed Mean/Sum/Count/Min/Max over (Y, X) of every member of a
    (Y, X, E) f32 field; returns (Y, X, E). The counterpart of
    gridpp_tpu/ops/pallas_stencil.py::neighbourhood_members (which gates
    on the TPU's VMEM; this takes any size that fits the card). A CUDA
    tensor goes through K5, a CPU tensor through its plain version."""
    statistic = int(statistic)
    h = int(halfwidth)
    if statistic not in MEMBER_STATS:
        raise ValueError(f"statistic {statistic} is not Mean, Sum, Count, "
                         "Min or Max")
    if h < 0:
        raise ValueError("halfwidth must be >= 0")
    if x.dim() != 3:
        raise ValueError(f"expected (Y, X, E), got {tuple(x.shape)}")
    x = x.to(torch.float32)
    if h == 0:
        return single_cell(x, statistic)
    hy = min(h, x.shape[0] - 1)
    hx = min(h, x.shape[1] - 1)
    if x.is_cuda:
        return neighbourhood_members_cuda(x.contiguous(), hy, hx, statistic)
    if x.device.type != "cpu":
        raise ValueError(f"no neighbourhood kernel for device {x.device}")
    return neighbourhood_members_plain(x, hy, hx, statistic)


class MemberPlan(NamedTuple):
    """K5's launch plan: a block owns K5_ROWS x `bx` grid cells of `chunk`
    members; its halo tile rows are `pitch` floats; `smem` bytes."""
    bx: int
    chunk: int
    pitch: int
    smem: int


def member_plan(nx: int, e: int, hy: int, hx: int, stat: int) -> MemberPlan:
    """K5's plan for a (Y, nx, e) field and clipped halfwidths. A block
    takes every member where shared memory allows (its tile rows are then
    contiguous runs of the (Y, X * E) view), else the largest chunk that
    fits, and about K5_WIDTH floats of tile row: bx = K5_WIDTH // chunk -
    2hx grid columns, at least 1, and fewer where the tile would not fit.
    Shared memory: the (K5_ROWS + 2hy) x pitch f32 tile, plus K5_ROWS x
    pitch 16-bit vertical counts for Mean/Sum/Count; the pitch is
    (bx + 2hx) * chunk + 3 rounded up to 4 floats (room for each row's
    16-byte alignment shift). Raises a "shared memory" ValueError where not
    even one member of one grid column fits."""
    per_pitch = 4 * (K5_ROWS + 2 * hy) + (2 * K5_ROWS
                                          if int(stat) in MEAN_STATS else 0)
    widest = SMEM_LIMIT // per_pitch // 4 * 4 - 3  # tile row floats
    for chunk in range(e, 0, -1):
        bx = min(max(1, K5_WIDTH // chunk - 2 * hx), nx,
                 widest // chunk - 2 * hx)
        if bx >= 1:
            pitch = -(-((bx + 2 * hx) * chunk + 3) // 4) * 4
            return MemberPlan(bx, chunk, pitch, per_pitch * pitch)
    raise ValueError(f"neighbourhood_members: halfwidths ({hy}, {hx}) need "
                     "more shared memory than the device gives one block")


def neighbourhood_members_cuda(x: torch.Tensor, hy: int, hx: int,
                               stat: int) -> torch.Tensor:
    """Launch K5 on a contiguous (Y, X, E) CUDA tensor (member_plan's
    tiling); returns (Y, X, E)."""
    stat = int(stat)
    if x.dim() != 3:
        raise ValueError(f"expected (Y, X, E), got {tuple(x.shape)}")
    _check_args(x[..., 0], hy, hx, stat, MEMBER_STATS,
                "Mean, Sum, Count, Min or Max")
    _check_cuda(x, "neighbourhood_members_cuda")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ny, nx, e = x.shape
    plan = member_plan(nx, e, hy, hx, stat)
    _launch("neighbourhood_members", x, x.data_ptr(), out.data_ptr(), ny, nx,
            e, hy, hx, plan.bx, plan.chunk, plan.pitch, stat)
    neighbourhood_members_cuda.launches += 1
    return out


neighbourhood_members_cuda.launches = 0


def neighbourhood_members_plain(x: torch.Tensor, hy: int, hx: int,
                                stat: int) -> torch.Tensor:
    """K5 in plain PyTorch: K1's or K2's plain version on the (E, Y, X)
    view of the members."""
    stat = int(stat)
    if x.dim() != 3:
        raise ValueError(f"expected (Y, X, E), got {tuple(x.shape)}")
    planes = x.permute(2, 0, 1)
    if stat in MINMAX_STATS:
        out = neighbourhood_minmax_plain(planes, hy, hx, stat)
    else:
        out = neighbourhood_mean_plain(planes, hy, hx, stat)
    return out.permute(1, 2, 0)
