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
  K4 neighbourhood_quantile_fast_cuda  csrc/neighbourhood_wide.cu
     replaces ::_qf_kernel
  K5 neighbourhood_members_cuda        csrc/neighbourhood_members.cu
     replaces ::_member_mean_kernel and ::_member_minmax_kernel
  wide route of K1-K3 and K5          csrc/neighbourhood_wide.cu

The same registry (`KERNELS`, `build_kernel`) builds and binds the EnSI
transform's kernel, csrc/ensi_transform.cu, whose wrapper and plain version
live with the transform in ops/oi_ensi.py (`ensi_update_cuda`).

`stencil_plan` (Python, so that the CPU tests reach it) picks each call's
route from the shapes and halfwidths: "fused", the kernel's own one-launch
kernel, where its shared-memory tile fits a block and the halfwidths are at
most the measured crossover FUSED_MAX_H (every kernel but K4 at h=7), else
"wide", two launches of csrc/neighbourhood_wide.cu through a scratch buffer
that the wrapper allocates, which take any halfwidth. K4 has only the wide
route: its exact running counts cost the same at every halfwidth and were
not slower than a one-block kernel at any. The fused launches take a plan
of their own: K1/K2/K3 `strip_plan`, K5 `member_plan`.

A `*_cuda` wrapper takes only a CUDA tensor and launches its kernel, or
raises; it counts its calls in `<wrapper>.launches` (one a call, whatever
the route) and the calls that took the wide route in `<wrapper>.wide`.
Beside each sits its plain PyTorch version (`*_plain`; K4's is
ops/neighbourhood.py::_quantile_fast_xla): the CPU path, and the reference
the kernel is held to on the card. ops/neighbourhood.py picks one by where
the tensor lies; `neighbourhood_members` does so here.

The stencils take x of shape (Y, X) or (B, Y, X), f32, and halfwidths
already clipped to the grid (hy <= Y - 1, hx <= X - 1); a leading axis is a
batch of independent planes.
"""
from __future__ import annotations

import ctypes
import functools
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
    "strip_plan", "strip_smem", "strip_width", "stencil_plan",
    "wide_scratch",
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
           "neighbourhood_members": "nbk_launch",
           "neighbourhood_wide": "nbw_launch",
           "ensi_transform": "ens_launch"}

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_c_p, _c_i = ctypes.c_void_p, ctypes.c_int
# nbm_launch, nbx_launch and nbv_launch share one signature (K1/K2/K3: with
# the strip width and run length)
_STRIP_ARGS = [_c_p, _c_p] + [_c_i] * 8 + [_c_i, _c_p]
_ARGTYPES = {"nbm_launch": _STRIP_ARGS, "nbx_launch": _STRIP_ARGS,
             "nbv_launch": _STRIP_ARGS,
             "nbk_launch": [_c_p, _c_p] + [_c_i] * 8 + [_c_i, _c_p],
             "nbw_launch": [_c_p] * 6 + [_c_i, _c_p] + [_c_i] * 7
             + [_c_i, _c_p],
             "ens_launch": [_c_p] * 7 + [ctypes.c_longlong] * 2
             + [_c_i] * 3 + [ctypes.POINTER(ctypes.c_float), _c_i]
             + [_c_i, _c_p]}
_libs: dict = {}

# the dynamic shared memory one block may opt in to on an H100 (232,448
# bytes); the launch functions check the device's own limit again
SMEM_LIMIT = 232448
# an H100 SXM's shared memory per SM (228 KB; each block also holds 1 KB
# of the system's) and its SMs (the wrapper reads the device's own count)
SMEM_PER_SM = 233472
H100_SMS = 132
# K1/K2/K3's strip walk (csrc/stencil_strip.cuh): output rows of a chunk,
# the tile row that one round of a block's threads takes, the largest hx of
# the register horizontal pass, the outputs of a horizontal task, the
# blocks an SM keeps in flight (its __launch_bounds__), and the narrowest
# strip
STRIP_CHUNK, STRIP_W, STRIP_HCAP, STRIP_OUT = 16, 128, 8, 8
STRIP_BLOCKS_PER_SM, STRIP_MIN_BW = 3, 64
# planes of vertical results a strip block keeps (result_planes): K1 its
# sums and counts, K2 its extrema, K3 its sums, sums of squares and counts
STRIP_PLANES = {"K1": 2, "K2": 1, "K3": 3}
# The largest halfwidth (hy and hx) at which a one-block kernel beats the
# wide route on an H100 (tools/torch_route_sweep.py at 2000², K5 with 10
# members).
FUSED_MAX_H = {"K1": 64, "K2": 60, "K3": 83, "K5": 10}
# K4's epilogue reads a window's counts as int32 (qf_epilogue.cuh)
QF_MAX_CELLS = 1 << 31
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
    headers = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                     if f.endswith(".cuh"))
    nvcc = _nvcc()
    return build_shared(
        name, [src] + headers,
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
    if err == -2:
        raise RuntimeError(f"{name}: the launch refused its arguments or "
                           "plan")
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


_sms: dict = {}


def _device_sms(device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def _ceil4(v: int) -> int:
    return -(-v // 4) * 4


def strip_width(hx: int) -> int:
    """K1/K2/K3's strip of output columns: the widest multiple of STRIP_OUT
    whose tile row (bw + 2hx) fits STRIP_W floats, so each pass takes one
    round of the block's threads (112 at hx=7); at least STRIP_MIN_BW."""
    return max(STRIP_MIN_BW, (STRIP_W - 2 * hx) // STRIP_OUT * STRIP_OUT)


def strip_smem(bw: int, hy: int, hx: int, planes: int) -> int:
    """Shared memory of one K1/K2/K3 block (csrc/stencil_strip.cuh,
    strip_smem): a ring of 2 STRIP_CHUNK + 2hy input rows, each bw + 2hx
    floats plus room for its 16-byte shift, and `planes` (STRIP_PLANES)
    planes of STRIP_CHUNK rows of vertical results, each row bw + 2
    max(hx, STRIP_HCAP) floats, rounded up to 4 within the cap and to an
    odd count above it (v_pitch)."""
    pitch = _ceil4(bw + 2 * hx + 3)
    vp = (bw + 2 * hx) | 1 if hx > STRIP_HCAP else _ceil4(bw + 2 * STRIP_HCAP)
    return 4 * ((2 * STRIP_CHUNK + 2 * hy) * pitch
                + planes * STRIP_CHUNK * vp)


class StripPlan(NamedTuple):
    """K1/K2/K3's launch plan: a block walks `rows` output rows (a multiple
    of STRIP_CHUNK) of a `bw`-column strip; `blocks` blocks of `smem`
    bytes."""
    bw: int
    rows: int
    blocks: int
    smem: int


def _strip_fit(planes, ny, nx, hy, hx, results, sms):
    bw = strip_width(hx)
    smem = strip_smem(bw, hy, hx, results)
    if smem > SMEM_LIMIT:
        return None
    per_sm = max(1, min(STRIP_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    strips = -(-nx // bw)
    runs = max(1, sms * per_sm // (strips * planes))
    rows = -(-(-(-ny // runs)) // STRIP_CHUNK) * STRIP_CHUNK
    return StripPlan(bw, rows, strips * -(-ny // rows) * planes, smem)


def strip_plan(shape, hy: int, hx: int, kernel: str,
               sms: int = H100_SMS) -> StripPlan:
    """The plan of `kernel` ("K1", "K2" or "K3", which keep STRIP_PLANES
    planes of vertical results) for a (Y, X) or (B, Y, X) field: the
    strip width from hx (strip_width), and the rows of a run set so that
    the strips x runs x planes blocks make about one wave of `sms` SMs at
    the blocks an SM holds. Raises a "shared memory" ValueError where the
    ring does not fit a block."""
    ny, nx = shape[-2:]
    planes = shape[0] if len(shape) == 3 else 1
    plan = _strip_fit(planes, ny, nx, hy, hx, STRIP_PLANES[kernel], sms)
    if plan is None:
        raise ValueError(f"strip_plan: halfwidths ({hy}, {hx}) need more "
                         "shared memory than the device gives one block")
    return plan


class StencilPlan(NamedTuple):
    """A stencil call's route, "fused" (the kernel's one launch) or "wide"
    (csrc/neighbourhood_wide.cu), with the fused launch's own plan
    (StripPlan for K1/K2/K3, MemberPlan for K5; None on the wide route)
    and the wide route's scratch: (dtype, elements) of each buffer (empty
    on the fused route)."""
    route: str
    fused: object
    scratch: tuple


def wide_scratch(kernel: str, shape, stat=None, t: int = 0,
                 hy: int | None = None) -> tuple:
    """The wide route's scratch buffers, (dtype, elements) each, in the
    order nbw_launch takes them: f32 sums and int32 counts (K1, K5 sums);
    f32 sums and sums of squares and int32 counts (K3); f32 extrema (K2,
    K5 Min/Max); K4's vertical window counts of its t + 1 lanes, packed in
    32-bit words with lanes as wide as min(2hy + 1, Y) needs (qf_lane_bits;
    csrc/neighbourhood_wide.cu, run_quantile), so K4 needs hy."""
    n = 1
    for d in shape:
        n *= int(d)
    f32, i32 = torch.float32, torch.int32
    if kernel == "K4":
        if hy is None:
            raise ValueError("wide_scratch: K4's scratch needs hy")
        bits = qf_lane_bits(min(2 * hy + 1, int(shape[-2])))
        return ((i32, qf_words(t, bits) * n),)
    if kernel == "K3":
        return ((f32, n), (f32, n), (i32, n))
    if int(stat) in MINMAX_STATS:
        return ((f32, n),)
    return ((f32, n), (i32, n))


def stencil_plan(kernel: str, shape, hy: int, hx: int, stat=None,
                 t: int = 0, sms: int = H100_SMS) -> StencilPlan:
    """The route of a stencil call on the card, from its shapes alone.

    kernel: "K1" (Mean/Sum/Count), "K2" (Min/Max) or "K3" (Std/Variance)
    on a (Y, X) or (B, Y, X) field, "K4" on (Y, X) with t thresholds, "K5"
    on (Y, X, E) with `stat`; (hy, hx) clipped to the grid. The one-launch
    kernel (its own plan) where its tile fits one block and the
    halfwidths are at most FUSED_MAX_H; else the wide route, which takes
    any halfwidth and is K4's only route. K4 raises a ValueError where a
    clipped window holds 2^31 cells or more (its counts would not fit
    int32) or its t + 1 lanes' carries would not fit a block's shared
    memory. Plans are cached: a serving loop asks for the same one every
    cycle."""
    return _stencil_plan(kernel, tuple(int(d) for d in shape), int(hy),
                         int(hx), None if stat is None else int(stat),
                         int(t), int(sms))


@functools.lru_cache(maxsize=256)
def _stencil_plan(kernel, shape, hy, hx, stat, t, sms):
    if kernel in STRIP_PLANES:
        fused = _strip_fit(shape[0] if len(shape) == 3 else 1,
                           shape[-2], shape[-1], hy, hx, STRIP_PLANES[kernel],
                           sms)
    elif kernel == "K4":
        _check_quantile_window(shape, hy, hx, t)
        fused = None
    elif kernel == "K5":
        fused = _member_fit(shape[1], shape[2], hy, hx, stat)
    else:
        raise ValueError(f"no stencil kernel {kernel!r}")
    if fused is not None and max(hy, hx) <= FUSED_MAX_H[kernel]:
        return StencilPlan("fused", fused, ())
    return StencilPlan("wide", None, wide_scratch(kernel, shape, stat, t,
                                                  hy))


def _check_quantile_window(shape, hy, hx, t):
    """K4's guards (csrc/neighbourhood_wide.cu): the epilogue reads a
    window's counts as int32, below QF_MAX_CELLS cells, and the wide
    route's horizontal pass keeps four 32-bit carries a lane (16 (t + 1)
    bytes) and its scan's 1 KB in shared memory. The counts stay exact
    integers to there; from 2^24 cells on, their conversion to f32 rounds,
    as the plain version's f32 window sums do, but not always to the same
    last bit (ROADMAP F8)."""
    cells = min(2 * hy + 1, shape[-2]) * min(2 * hx + 1, shape[-1])
    if cells >= QF_MAX_CELLS:
        raise ValueError(f"neighbourhood_quantile_fast: a window of {cells} "
                         f"cells (halfwidths ({hy}, {hx}) on {tuple(shape)}) "
                         "reaches 2^31, past which its counts do not fit "
                         "int32")
    if 16 * (t + 1) + 1024 > SMEM_LIMIT:
        raise ValueError(f"neighbourhood_quantile_fast: {t} thresholds need "
                         "more shared memory than the device gives one block")


def _launch_wide(x, out, plan, planes, ny, nx, e, hy, hx, stat,
                 thr=None, q=None):
    """Both passes of csrc/neighbourhood_wide.cu, scratch from
    plan.scratch."""
    bufs = [torch.empty(n, dtype=dt, device=x.device)
            for dt, n in plan.scratch]
    ptrs = [b.data_ptr() for b in bufs] + [None] * (3 - len(bufs))
    _launch("neighbourhood_wide", x, x.data_ptr(), out.data_ptr(), *ptrs,
            None if thr is None else thr.data_ptr(),
            0 if thr is None else thr.numel(),
            None if q is None else q.data_ptr(), planes, ny, nx, e, hy, hx,
            stat)


def _plane_stencil(kernel, wrapper, x, hy, hx, stat):
    """Launch K1/K2/K3 on the contiguous planes of x, by the route
    stencil_plan picks; returns a new tensor of x's shape."""
    _check_cuda(x, wrapper.__name__)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b = x.shape[0] if x.dim() == 3 else 1
    ny, nx = x.shape[-2:]
    plan = stencil_plan(kernel, x.shape, hy, hx, stat,
                        sms=_device_sms(x.device))
    if plan.route == "wide":
        _launch_wide(x, out, plan, b, ny, nx, 1, hy, hx, stat)
        wrapper.wide += 1
    else:
        _launch(_PLANE_SOURCES[kernel], x, x.data_ptr(), out.data_ptr(), b,
                ny, nx, hy, hx, plan.fused.bw, plan.fused.rows, stat)
    wrapper.launches += 1
    return out


_PLANE_SOURCES = {"K1": "neighbourhood_mean", "K2": "neighbourhood_minmax",
                  "K3": "neighbourhood_var"}


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
    return _plane_stencil("K1", neighbourhood_mean_cuda, x, hy, hx, stat)


neighbourhood_mean_cuda.launches = 0
neighbourhood_mean_cuda.wide = 0


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
    return _plane_stencil("K2", neighbourhood_minmax_cuda, x, hy, hx, stat)


neighbourhood_minmax_cuda.launches = 0
neighbourhood_minmax_cuda.wide = 0


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
    return _plane_stencil("K3", neighbourhood_var_cuda, x, hy, hx, stat)


neighbourhood_var_cuda.launches = 0
neighbourhood_var_cuda.wide = 0


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


def neighbourhood_quantile_fast_cuda(x: torch.Tensor, quantile, hy: int,
                                     hx: int, thresholds: torch.Tensor
                                     ) -> torch.Tensor:
    """Launch K4 (its two passes in csrc/neighbourhood_wide.cu) on a (Y, X)
    CUDA tensor with a scalar quantile (a number or a one-element tensor)
    and (T,) thresholds; returns (Y, X). A non-finite quantile gives NaN
    everywhere."""
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
    plan = stencil_plan("K4", x.shape, hy, hx, t=thr.numel())
    _launch_wide(x, out, plan, 1, ny, nx, 1, hy, hx, int(Statistic.Quantile),
                 thr, q)
    neighbourhood_quantile_fast_cuda.wide += 1
    neighbourhood_quantile_fast_cuda.launches += 1
    return out


neighbourhood_quantile_fast_cuda.launches = 0
neighbourhood_quantile_fast_cuda.wide = 0


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
    """K5's launch plan: a block owns K5_ROWS x `bx` grid cells of every
    member; its halo tile rows are `pitch` floats; `smem` bytes."""
    bx: int
    pitch: int
    smem: int


def member_plan(nx: int, e: int, hy: int, hx: int, stat: int) -> MemberPlan:
    """K5's plan for a (Y, nx, e) field and clipped halfwidths. A block
    takes every member (its tile rows are then contiguous runs of the
    (Y, X * E) view) and about K5_WIDTH floats of tile row: bx = K5_WIDTH
    // e - 2hx grid columns, at least 1, and fewer where the tile would not
    fit. Shared memory: the (K5_ROWS + 2hy) x pitch f32 tile, plus K5_ROWS
    x pitch 16-bit vertical counts for Mean/Sum/Count; the pitch is
    (bx + 2hx) * e + 3 rounded up to 4 floats (room for each row's 16-byte
    alignment shift). Raises a "shared memory" ValueError where not even
    one grid column of every member fits (stencil_plan sends that to the
    wide route)."""
    plan = _member_fit(nx, e, hy, hx, stat)
    if plan is None:
        raise ValueError(f"neighbourhood_members: halfwidths ({hy}, {hx}) "
                         "need more shared memory than the device gives one "
                         "block")
    return plan


def _member_fit(nx: int, e: int, hy: int, hx: int, stat: int):
    per_pitch = 4 * (K5_ROWS + 2 * hy) + (2 * K5_ROWS
                                          if int(stat) in MEAN_STATS else 0)
    widest = SMEM_LIMIT // per_pitch // 4 * 4 - 3  # tile row floats
    bx = min(max(1, K5_WIDTH // e - 2 * hx), nx, widest // e - 2 * hx)
    if bx < 1:
        return None
    pitch = -(-((bx + 2 * hx) * e + 3) // 4) * 4
    return MemberPlan(bx, pitch, per_pitch * pitch)


def neighbourhood_members_cuda(x: torch.Tensor, hy: int, hx: int,
                               stat: int) -> torch.Tensor:
    """Launch K5 on a contiguous (Y, X, E) CUDA tensor (member_plan's
    tiling, or the wide route on the (Y, X * E) view, as stencil_plan
    picks); returns (Y, X, E)."""
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
    plan = stencil_plan("K5", x.shape, hy, hx, stat)
    if plan.route == "wide":
        _launch_wide(x, out, plan, 1, ny, nx, e, hy, hx, stat)
        neighbourhood_members_cuda.wide += 1
    else:
        mp = plan.fused
        _launch("neighbourhood_members", x, x.data_ptr(), out.data_ptr(), ny,
                nx, e, hy, hx, mp.bx, mp.pitch, stat)
    neighbourhood_members_cuda.launches += 1
    return out


neighbourhood_members_cuda.launches = 0
neighbourhood_members_cuda.wide = 0


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
