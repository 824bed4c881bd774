// The wide route of the neighbourhood stencils K1-K5 for Hopper (sm_90a):
// any halfwidth, in two launches through a scratch buffer in device memory.
//
// The one-block kernels (neighbourhood_mean.cu, _minmax.cu, _var.cu,
// _quantile_fast.cu, _members.cu) keep a halo tile of (rows + 2hy) x
// (columns + 2hx) floats in shared memory, so each has a largest
// halfwidth; ops/stencil.py::stencil_plan sends every launch past it here.
// It replaces the same TPU kernels as those (gridpp_tpu/ops/
// pallas_stencil.py::_mean_kernel, _minmax_kernel, _var_kernel, _qf_kernel,
// _member_mean_kernel, _member_minmax_kernel), whose reference route,
// lax.reduce_window, takes any halfwidth.
//
// K1, K2, K3 and K5 (wide_fold): both passes are one column fold. A thread
// takes a column of a (R, C) matrix and a run of kRun output rows, and
// forms each output's direct (2h+1)-term result over the window's rows
// inside the domain:
//   sums (f32) and counts of finite cells (int32): K1, K5 Mean/Sum/Count;
//   sums, sums of squares and counts, with K3's explicitly rounded
//     intrinsics (neighbourhood_var.cu): K3;
//   extrema, non-finite cells read as the identity: K2, K5 Min/Max.
// Where the window is at least kRun rows, every output of the run holds
// the same core rows, which are folded once: output k is (head rows of k
// above the core, folded bottom up) with the core, then (tail rows below
// the core, top down), so the run costs about 2 kRun + 2h terms instead of
// kRun (2h+1), and each output is still a direct sum of its window (no
// running add-and-subtract); the core's sum is taken in blocks of kBlock
// terms. The first pass folds down the columns of the (Y, X * E) field
// (E = 1 but for K5's members) and writes its results transposed,
// (X, Y * E); the second pass folds down the columns of that, which walks
// the window along x with coalesced reads, and writes the finalized
// statistic back transposed, (Y, X * E).
//
// K4 (quantile_vertical, quantile_horizontal): the vertical pass counts,
// for each lane l <= T, the finite cells with v <= lt_l (lt_0 = +inf,
// lt_k = thresholds[k - 1]) down each column, eight lanes per walk, into
// int32 planes; the horizontal pass sums each lane over the window's
// columns and reads the quantile off the counts with the fused K4's own
// epilogue (qf_epilogue.cuh), so it stays bit for bit with
// ops/neighbourhood.py::_quantile_fast_xla.
//
// Counts are exact integers; a count up to (2h+1)^2 converts to f32
// exactly below 2^24, which covers h = 2000 (4001^2 = 16,008,001).
//
// What bounds it: the window's operations, about (2 kRun + 2h) / kRun a
// cell and pass for the folds and (T + 1)(2h + 1) for K4, served by L1/L2
// (neighbouring threads read neighbouring addresses); the transposed
// writes are scattered.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py,
// which allocates the scratch: wide_scratch).

#include <stdint.h>

#include "qf_epilogue.cuh"
#include "stencil_tile.cuh"

namespace {

using namespace stencil;

constexpr int kStatQuantile = 40;  // Statistic.Quantile: K4's wide route
constexpr int kWideThreads = 256;
constexpr int kRun = 16;    // output rows a thread folds
constexpr int kBlock = 32;  // terms of a block of the core's direct sum
constexpr int kLanes = 8;   // K4 lanes counted in one vertical walk

enum Mode { kSums, kVar, kMin, kMax };

// A partial result: sum or extremum s, sum of squares s2 (K3), count n.
struct Acc {
  float s, s2;
  int n;
};

template <Mode kMode>
__device__ __forceinline__ Acc empty() {
  return {kMode == kMin ? INFINITY : (kMode == kMax ? -INFINITY : 0.0f),
          0.0f, 0};
}

template <Mode kMode>
__device__ __forceinline__ Acc join(const Acc& a, const Acc& b) {
  if (kMode == kMin) return {fminf(a.s, b.s), 0.0f, 0};
  if (kMode == kMax) return {fmaxf(a.s, b.s), 0.0f, 0};
  if (kMode == kVar) {
    return {__fadd_rn(a.s, b.s), __fadd_rn(a.s2, b.s2), a.n + b.n};
  }
  return {a.s + b.s, 0.0f, a.n + b.n};
}

// One field cell as a partial result (non-finite: missing).
template <Mode kMode>
__device__ __forceinline__ Acc cell(float v) {
  const bool fin = isfinite(v);
  if (kMode == kMin || kMode == kMax) {
    return {fin ? v : empty<kMode>().s, 0.0f, 0};
  }
  return {fin ? v : 0.0f, kMode == kVar && fin ? __fmul_rn(v, v) : 0.0f,
          fin ? 1 : 0};
}

// One pass of the fold over the (R, C) matrices of blockIdx.z: column c,
// output rows [r0, r0 + kRun). kFirst: reads the field x (C = X * E) and
// writes the partial results to o0/o1/on; else reads them (C = Y * E) as
// i0/i1/in and writes the statistic to out. Output (r, c) goes to the
// transposed position (c / e, r * e + c % e).
template <Mode kMode, bool kFirst>
__global__ void __launch_bounds__(kWideThreads)
wide_fold(const float* __restrict__ x, const float* __restrict__ i0,
          const float* __restrict__ i1, const int* __restrict__ in,
          float* __restrict__ o0, float* __restrict__ o1,
          int* __restrict__ on, float* __restrict__ out, int R, int C, int e,
          int h, int stat) {
  const int c = blockIdx.x * kWideThreads + threadIdx.x;
  if (c >= C) return;
  const long long plane = static_cast<long long>(blockIdx.z) * R * C;
  const int r0 = blockIdx.y * kRun;
  const int n_out = min(kRun, R - r0);
  const bool sums = kMode == kSums || kMode == kVar;
  auto load = [&](int r) -> Acc {
    const long long i = plane + static_cast<long long>(r) * C + c;
    if (kFirst) return cell<kMode>(__ldg(x + i));
    return {__ldg(i0 + i), kMode == kVar ? __ldg(i1 + i) : 0.0f,
            sums ? __ldg(in + i) : 0};
  };
  const long long col = plane + static_cast<long long>(c / e) * R * e + c % e;
  auto emit = [&](int r, const Acc& a) {
    const long long o = col + static_cast<long long>(r) * e;
    if (kFirst) {
      o0[o] = a.s;
      if (kMode == kVar) o1[o] = a.s2;
      if (sums) on[o] = a.n;
      return;
    }
    float res;
    if (kMode == kMin || kMode == kMax) {
      res = isfinite(a.s) ? a.s : NAN;
    } else if (kMode == kVar) {
      res = NAN;
      if (a.n > 0) {
        const float cden = fmaxf(static_cast<float>(a.n), 1.0f);
        const float mean = __fdiv_rn(a.s, cden);
        const float mean2 = __fdiv_rn(a.s2, cden);
        res = __fsub_rn(mean2, __fmul_rn(mean, mean));
        if (stat == kStatStd) res = __fsqrt_rn(res);
      }
    } else if (stat == kStatCount) {
      res = static_cast<float>(a.n);
    } else if (a.n > 0) {
      // IEEE division: the plain K4 smooths its indicator planes with K1
      res = stat == kStatSum ? a.s
                             : a.s / fmaxf(static_cast<float>(a.n), 1.0f);
    } else {
      res = NAN;
    }
    out[o] = res;
  };
  // the direct sum of rows [lo, hi], in blocks of kBlock terms
  auto window = [&](int lo, int hi) {
    Acc total = empty<kMode>(), part = empty<kMode>();
    int k = 0;
    for (int r = lo; r <= hi; ++r) {
      part = join<kMode>(part, load(r));
      if (++k == kBlock || r == hi) {
        total = join<kMode>(total, part);
        part = empty<kMode>();
        k = 0;
      }
    }
    return total;
  };

  if (2 * h + 1 >= kRun) {
    // head[k]: rows lo_k .. lo_last - 1 (lo_k = max(r0 + k - h, 0))
    Acc head[kRun];
    head[kRun - 1] = empty<kMode>();
#pragma unroll
    for (int k = kRun - 2; k >= 0; --k) {
      const int r = r0 + k - h;
      head[k] = k < n_out - 1
                    ? join<kMode>(r >= 0 ? load(r) : empty<kMode>(),
                                  head[k + 1])
                    : empty<kMode>();
    }
    const Acc core = window(max(r0 + n_out - 1 - h, 0), min(r0 + h, R - 1));
    Acc tail = empty<kMode>();  // rows hi_0 + 1 .. hi_k
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      if (k < n_out) {
        if (k > 0 && r0 + k + h <= R - 1) {
          tail = join<kMode>(tail, load(r0 + k + h));
        }
        emit(r0 + k, join<kMode>(join<kMode>(head[k], core), tail));
      }
    }
  } else {
    for (int k = 0; k < n_out; ++k) {
      const int r = r0 + k;
      emit(r, window(max(r - h, 0), min(r + h, R - 1)));
    }
  }
}

// K4's vertical pass over a (ny, nx) field: for column j of rows
// [y0, y0 + kRun), the count of each lane l <= t over the window's rows,
// into lane plane l of n0.
__global__ void __launch_bounds__(kWideThreads)
quantile_vertical(const float* __restrict__ x, int* __restrict__ n0,
                  const float* __restrict__ thr, int t, int ny, int nx,
                  int hy) {
  const int j = blockIdx.x * kWideThreads + threadIdx.x;
  if (j >= nx) return;
  const int y0 = blockIdx.y * kRun;
  const int y1 = min(y0 + kRun, ny);
  const long long lane_stride = static_cast<long long>(ny) * nx;
  for (int y = y0; y < y1; ++y) {
    const int lo = max(y - hy, 0);
    const int hi = min(y + hy, ny - 1);
    const long long o = static_cast<long long>(y) * nx + j;
    for (int l0 = 0; l0 <= t; l0 += kLanes) {
      float lt[kLanes];
      int cnt[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int lane = l0 + l;
        lt[l] = lane == 0 ? INFINITY
                          : (lane <= t ? __ldg(thr + lane - 1) : NAN);
        cnt[l] = 0;
      }
      for (int r = lo; r <= hi; ++r) {
        const float v = __ldg(x + static_cast<long long>(r) * nx + j);
        const bool fin = isfinite(v);
#pragma unroll
        for (int l = 0; l < kLanes; ++l) cnt[l] += fin && v <= lt[l];
      }
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        if (l0 + l <= t) n0[(l0 + l) * lane_stride + o] = cnt[l];
      }
    }
  }
}

// Window sum of an int32 lane plane over columns [lo, hi] of a row.
__device__ __forceinline__ int lane_window(const int* __restrict__ row,
                                           int lo, int hi) {
  int s = 0;
  for (int c = lo; c <= hi; ++c) s += __ldg(row + c);
  return s;
}

// K4's horizontal pass and epilogue: output column j of rows
// [y0, y0 + kRun).
__global__ void __launch_bounds__(kWideThreads)
quantile_horizontal(const int* __restrict__ n0,
                    const float* __restrict__ thr, int t,
                    const float* __restrict__ qp, float* __restrict__ out,
                    int ny, int nx, int hx) {
  const int j = blockIdx.x * kWideThreads + threadIdx.x;
  if (j >= nx) return;
  const int lo = max(j - hx, 0);
  const int hi = min(j + hx, nx - 1);
  const int y0 = blockIdx.y * kRun;
  const int y1 = min(y0 + kRun, ny);
  const long long lane_stride = static_cast<long long>(ny) * nx;
  const float q = __ldg(qp);
  const qf::Packing pk{32, 1, 0xffffffffu};
  for (int y = y0; y < y1; ++y) {
    const int* row = n0 + static_cast<long long>(y) * nx;
    qf::Cell cl;
    for (int l = 0; l <= t; ++l) {
      const unsigned acc[1] = {
          static_cast<unsigned>(lane_window(row + l * lane_stride, lo, hi))};
      qf::tally<1>(acc, 1, l, pk, t, q, cl);
    }
    qf::bracket(t, cl);
    cl.s0 = lane_window(row + (cl.i0c + 1) * lane_stride, lo, hi);
    cl.s1 = lane_window(row + (cl.i1c + 1) * lane_stride, lo, hi);
    out[static_cast<long long>(y) * nx + j] = qf::inverse_cdf(cl, thr, t, q);
  }
}

template <Mode kMode>
int run_fold(const float* x, float* out, float* s0, float* s1, int* n,
             int planes, int ny, int nx, int e, int hy, int hx, int stat,
             int device, cudaStream_t stream) {
  int err = prepare_launch(wide_fold<kMode, true>, 0, device);
  if (err != 0) return err;
  err = prepare_launch(wide_fold<kMode, false>, 0, device);
  if (err != 0) return err;
  const dim3 first((nx * e + kWideThreads - 1) / kWideThreads,
                   (ny + kRun - 1) / kRun, planes);
  wide_fold<kMode, true><<<first, kWideThreads, 0, stream>>>(
      x, nullptr, nullptr, nullptr, s0, s1, n, nullptr, ny, nx * e, e, hy,
      stat);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 second((ny * e + kWideThreads - 1) / kWideThreads,
                    (nx + kRun - 1) / kRun, planes);
  wide_fold<kMode, false><<<second, kWideThreads, 0, stream>>>(
      nullptr, s0, s1, n, nullptr, nullptr, nullptr, out, nx, ny * e, e, hx,
      stat);
  return static_cast<int>(cudaGetLastError());
}

int run_quantile(const float* x, float* out, int* n0, const float* thr,
                 int t, const float* q, int ny, int nx, int hy, int hx,
                 int device, cudaStream_t stream) {
  int err = prepare_launch(quantile_vertical, 0, device);
  if (err != 0) return err;
  err = prepare_launch(quantile_horizontal, 0, device);
  if (err != 0) return err;
  const dim3 grid((nx + kWideThreads - 1) / kWideThreads,
                  (ny + kRun - 1) / kRun);
  quantile_vertical<<<grid, kWideThreads, 0, stream>>>(x, n0, thr, t, ny,
                                                      nx, hy);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  quantile_horizontal<<<grid, kWideThreads, 0, stream>>>(n0, thr, t, q, out,
                                                        ny, nx, hx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: device pointers to `planes` contiguous planes of (ny, nx, e) f32
// (e = 1 for K1-K4; K5 passes its (Y, X, E) field as one plane). Scratch
// (ops/stencil.py::wide_scratch), each of planes x ny x nx x e elements:
//   Mean/Sum/Count: s0 f32 sums, s1 int32 counts;
//   Std/Variance:   s0 f32 sums, s1 f32 sums of squares, s2 int32 counts;
//   Min/Max:        s0 f32 extrema;
//   Quantile (K4; planes = e = 1, thresholds: t > 0 device f32, q: one
//   device f32): s0 int32, t + 1 lane planes.
// stream: a cudaStream_t of `device`. Returns 0, -2 for arguments it cannot
// take, or a cudaError_t.
int nbw_launch(const float* x, float* out, void* s0, void* s1, void* s2,
               const float* thresholds, int t, const float* q, int planes,
               int ny, int nx, int e, int hy, int hx, int stat, int device,
               void* stream) {
  if (planes < 1 || planes > 65535 || ny < 1 || nx < 1 || e < 1 || hy < 0 ||
      hx < 0 || static_cast<long long>(nx) * e > 0x7fffffffLL ||
      static_cast<long long>(ny) * e > 0x7fffffffLL || s0 == nullptr) {
    return -2;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f0 = static_cast<float*>(s0);
  switch (stat) {
    case kStatMean:
    case kStatSum:
    case kStatCount:
      if (s1 == nullptr) return -2;
      return run_fold<kSums>(x, out, f0, nullptr, static_cast<int*>(s1),
                             planes, ny, nx, e, hy, hx, stat, device, st);
    case kStatStd:
    case kStatVariance:
      if (s1 == nullptr || s2 == nullptr || e != 1) return -2;
      return run_fold<kVar>(x, out, f0, static_cast<float*>(s1),
                            static_cast<int*>(s2), planes, ny, nx, e, hy, hx,
                            stat, device, st);
    case kStatMin:
      return run_fold<kMin>(x, out, f0, nullptr, nullptr, planes, ny, nx, e,
                            hy, hx, stat, device, st);
    case kStatMax:
      return run_fold<kMax>(x, out, f0, nullptr, nullptr, planes, ny, nx, e,
                            hy, hx, stat, device, st);
    case kStatQuantile:
      if (planes != 1 || e != 1 || t < 1 || thresholds == nullptr ||
          q == nullptr) {
        return -2;
      }
      return run_quantile(x, out, static_cast<int*>(s0), thresholds, t, q,
                          ny, nx, hy, hx, device, st);
    default:
      return -2;
  }
}

}  // extern "C"
