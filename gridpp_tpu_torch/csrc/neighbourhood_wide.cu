// The wide route of the neighbourhood stencils K1-K5 for Hopper (sm_90a):
// any halfwidth, in two launches through a scratch buffer in device memory.
//
// The one-block kernels of K1, K2, K3 (neighbourhood_mean.cu, _minmax.cu,
// _var.cu) and K5 (neighbourhood_members.cu) keep rows of (columns + 2hx)
// floats and 2hy halo rows in shared memory, so each has a largest
// halfwidth, and each is faster only up to its crossover (FUSED_MAX_H);
// ops/stencil.py::stencil_plan sends every launch past it here. K4 has no
// one-block kernel: its running counts cost the same at every halfwidth, so
// every K4 launch comes here. This file replaces the same TPU kernels as
// those (gridpp_tpu/ops/pallas_stencil.py::_mean_kernel, _minmax_kernel,
// _var_kernel, _member_mean_kernel, _member_minmax_kernel; and _qf_kernel),
// whose reference route, lax.reduce_window, takes any halfwidth.
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
// K4 (quantile_vertical, quantile_horizontal) counts, for each lane l <= T,
// the finite cells with v <= lt_l (lt_0 = +inf, lt_k = thresholds[k - 1]),
// in exact integers, so each lane costs O(1) a cell whatever h:
//   vertical: a thread walks kQRun rows of a column, seeded with the direct
//     sum of its first window, then adds the row entering and subtracts the
//     row leaving, on packed words (qf_epilogue.cuh) whose lanes hold
//     2hy + 1 (8 bits to hy = 127, 16 to hy = 32767); coalesced reads and
//     writes of (words, Y, X) planes;
//   horizontal: a block takes a row and walks it in chunks of
//     2 kWideThreads columns, two outputs a thread, each window count the
//     difference of two inclusive prefixes of the row's words, widened on
//     loading to the lanes that hold the window (8 bits to 255 cells, 16 to
//     65,535, else 32): block-wide scans of the words at x + hx and
//     x - hx - 1 with carries from the chunks before. Then it reads the
//     quantile off the counts with qf_epilogue.cuh's epilogue.
// So it stays bit for bit with ops/neighbourhood.py::_quantile_fast_xla
// while a window's counts convert to f32 exactly, below 2^24 cells; past
// that the counts stay exact but their f32 conversion may round otherwise
// than the plain version's f32 window sums. The epilogue reads the counts as
// int32, below 2^31 cells a window, which stencil_plan checks.
//
// What bounds it: for the folds, the window's operations, about
// (2 kRun + 2h) / kRun a cell and pass, served by L1/L2 (neighbouring
// threads read neighbouring addresses), and the scattered transposed
// writes. For K4, the bytes: one read of the field, one write of the
// output, and the vertical counts' word planes written once and read back
// (twice, the second mostly from L2); then the T + 1 compares of each input
// read ((2hy + 1) / kQRun + 2 reads a cell) and the block scans of two
// words a word plane and cell.
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
constexpr int kQRun = 128;  // output rows of a K4 vertical-pass thread
constexpr int kQLanes = 16;  // lanes a K4 vertical-pass thread counts
constexpr int kQBatch = 8;   // rows a K4 vertical-pass thread loads at once
constexpr int kQGroupLanes = 12;  // lanes a K4 horizontal scan takes at once
constexpr int kWarps = kWideThreads / 32;

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

// -- K4 -----------------------------------------------------------------
// The lane width that holds counts up to `cells` (ops/stencil.py::
// qf_lane_bits): K4's vertical counts take it for min(2hy + 1, ny) cells
// (as wide_scratch sizes the scratch), its window counts for the clipped
// window, min(2hy + 1, ny) x min(2hx + 1, nx).
inline int lane_bits(long long cells) {
  return cells <= 255 ? 8 : (cells <= 65535 ? 16 : 32);
}

// K4's vertical pass: for column j, the rows [y0, y0 + kQRun) of blockIdx.y
// and the kQLanes lanes of the packed words [w0, w0 + kWords) of
// blockIdx.z, the window counts over rows [y - hy, y + hy] inside the
// domain, into word planes w of v (nw planes of ny x nx). The first output
// row takes the direct sum of its rows' packed indicator words; each next
// one adds the row entering the window and subtracts the row leaving it.
// Exact: plain 32-bit adds and subtracts of packed words whose lanes end
// within [0, 2hy + 1], which kBits holds (an intermediate carry into the
// next lane is taken back). Loads go kQBatch rows at a time, so that a
// thread keeps that many in flight.
template <int kBits>
__global__ void __launch_bounds__(kWideThreads)
quantile_vertical(const float* __restrict__ x, unsigned* __restrict__ v,
                  const float* __restrict__ thr, int t, int ny, int nx,
                  int hy, int nw) {
  constexpr int kWords = kQLanes * kBits / 32;
  const int j = blockIdx.x * kWideThreads + threadIdx.x;
  if (j >= nx) return;
  const int y0 = blockIdx.y * kQRun;
  const int y1 = min(y0 + kQRun, ny);
  const int w0 = blockIdx.z * kWords;
  const qf::Packing pk = qf::packing(kBits);
  float lt[kWords * 4];
  qf::lane_thresholds<kWords>(thr, t, w0, pk, lt);
  unsigned acc[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) acc[w] = 0;
  const float* col = x + j;
  // a NaN (an empty row) adds nothing
  auto row = [&](int r, bool in) {
    return in ? __ldg(col + static_cast<long long>(r) * nx) : NAN;
  };
  auto add = [&](float xv, bool leaving) {
    unsigned wd[kWords];
    qf::pack<kWords>(xv, lt, pk, wd);
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      acc[w] = leaving ? acc[w] - wd[w] : acc[w] + wd[w];
    }
  };
  const long long plane = static_cast<long long>(ny) * nx;
  auto store = [&](int y) {
    unsigned* o = v + static_cast<long long>(y) * nx + j;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w0 + w < nw) o[(w0 + w) * plane] = acc[w];
    }
  };
  const int r1 = min(y0 + hy, ny - 1);
  for (int r = max(y0 - hy, 0); r <= r1; r += kQBatch) {
    float xv[kQBatch];
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) xv[k] = row(r + k, r + k <= r1);
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) add(xv[k], false);
  }
  store(y0);
  for (int y = y0 + 1; y < y1; y += kQBatch) {
    float enter[kQBatch], leave[kQBatch];
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) {
      const int yk = y + k;
      enter[k] = row(yk + hy, yk < y1 && yk + hy < ny);
      leave[k] = row(yk - hy - 1, yk < y1 && yk - hy - 1 >= 0);
    }
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) {
      if (y + k < y1) {
        add(enter[k], false);
        add(leave[k], true);
        store(y + k);
      }
    }
  }
}

// Inclusive scan of a[0 .. N) over the block's threads in thread order,
// wrapping mod 2^32 (ws: kWarps x N words of shared memory): a warp's
// shuffles, then warp 0 scans the warps' sums and hands the block's sums
// to sink(i, sum), whose shared-memory writes every thread sees on return.
// Every thread must call it.
template <int N, class Sink>
__device__ __forceinline__ void block_scan(unsigned (&a)[N], unsigned* ws,
                                           Sink sink) {
  static_assert(N <= 32, "one lane of warp 0 a value");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned o = __shfl_up_sync(0xffffffffu, a[i], d);
      if (lane >= d) a[i] += o;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < N; ++i) ws[warp * N + i] = a[i];
  }
  __syncthreads();
  if (warp == 0 && lane < N) {
    unsigned run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned sum = ws[w * N + lane];
      ws[w * N + lane] = run;
      run += sum;
    }
    sink(lane, run);
  }
  __syncthreads();
  // ws is next written after the next scan's shuffles, which every lane
  // of this warp reaches only after these reads
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] += ws[warp * N + i];
}

// The kQGroupLanes lanes of group g of the vertical counts (kVBits-wide,
// nvw words a cell) at element `at` of their planes, 0 where !inside or
// past the words, widened to kBits-wide lanes into a[kOff ..].
template <int kVBits, int kBits, int kOff, int N>
__device__ __forceinline__ void load_group(const unsigned* __restrict__ v,
                                           long long plane, long long at,
                                           bool inside, int g, int nvw,
                                           unsigned (&a)[N]) {
  constexpr int kLv = 32 / kVBits;  // lanes a word, read and written
  constexpr int kLw = 32 / kBits;
  constexpr int kVW = kQGroupLanes / kLv;
  constexpr unsigned kVMask = kVBits == 32 ? 0xffffffffu
                                           : (1u << kVBits) - 1u;
  unsigned vw[kVW];
#pragma unroll
  for (int i = 0; i < kVW; ++i) {
    const int w = g * kVW + i;
    vw[i] = inside && w < nvw ? __ldg(v + w * plane + at) : 0u;
  }
  if constexpr (kVBits == kBits) {
#pragma unroll
    for (int i = 0; i < kVW; ++i) a[kOff + i] = vw[i];
  } else {
#pragma unroll
    for (int i = 0; i < kQGroupLanes / kLw; ++i) a[kOff + i] = 0;
#pragma unroll
    for (int l = 0; l < kQGroupLanes; ++l) {
      a[kOff + l / kLw] |= ((vw[l / kLv] >> ((l % kLv) * kVBits)) & kVMask)
                           << ((l % kLw) * kBits);
    }
  }
}

// K4's horizontal pass and epilogue over row blockIdx.x of the vertical
// counts v (kVBits-wide lanes), each group of lanes widened on loading to
// the kBits-wide lanes a window's count needs (nw words a cell). The window
// counts at column x are P(x + hx) - P(x - hx - 1), P the inclusive prefix
// of the row's words (0 before the row, the whole row past it), in plain
// 32-bit arithmetic: exact, as every lane of the difference ends within its
// width, whatever the prefixes carried across lanes. The block walks the
// row in chunks of 2 kWideThreads columns, two adjacent outputs a thread; a
// chunk takes both prefixes as block-wide scans of the words at x + hx and
// at x - hx - 1 (a thread's two columns summed) added to carries from the
// chunks before (the lead's carry starts as the sum of columns [0, hx)), so
// every word costs O(1) a cell whatever hx. The words of kQGroupLanes lanes
// are scanned together (T = 11 fills a group); where a cell's lanes fit one
// group (kSingle) the bracket's two counts are read from the same
// registers, else the groups are streamed for the tally and the groups
// holding a bracket end of some output of the chunk counted again (a
// block-wide vote). The epilogue is qf_epilogue.cuh's.
template <int kVBits, int kBits, bool kSingle>
__global__ void __launch_bounds__(kWideThreads)
quantile_horizontal(const unsigned* __restrict__ v,
                    const float* __restrict__ thr, int t,
                    const float* __restrict__ qp, float* __restrict__ out,
                    int ny, int nx, int hx, int nw) {
  constexpr int GW = kQGroupLanes * kBits / 32;  // words of a group
  const int nvw = (t + 32 / kVBits) / (32 / kVBits);  // read words a cell
  extern __shared__ unsigned qsm[];
  unsigned* carry = qsm;             // lead then trail prefixes, 2 nw
  unsigned* total = carry + 2 * nw;  // this chunk's sums of both, 2 nw
  unsigned* ws = total + 2 * nw;     // block_scan's, kWarps x 2 GW
  const long long plane = static_cast<long long>(ny) * nx;
  const long long row = static_cast<long long>(blockIdx.x) * nx;
  const qf::Packing pk = qf::packing(kBits);
  const float q = __ldg(qp);

  for (int w0 = 0; w0 < nw; w0 += GW) {
    unsigned a[GW], b[GW];
#pragma unroll
    for (int i = 0; i < GW; ++i) a[i] = 0;
    for (int c = threadIdx.x; c < hx; c += kWideThreads) {
      load_group<kVBits, kBits, 0>(v, plane, row + c, true, w0 / GW, nvw,
                                   b);
#pragma unroll
      for (int i = 0; i < GW; ++i) a[i] += b[i];
    }
    block_scan<GW>(a, ws, [&](int i, unsigned sum) {
      if (w0 + i < nw) {
        carry[w0 + i] = sum;
        carry[nw + w0 + i] = 0;
      }
    });
  }
  __syncthreads();  // the next scans lay ws out for 2 GW values

  // the window counts of words [w0, w0 + GW) at column xa + 1 (wb; 0 past
  // the nw words), and what column xa's counts lack of them: column xa +
  // 1's words at the lead less those at the trail (d); the chunk's sums go
  // to total
  auto window = [&](int xa, int w0, unsigned (&wb)[GW], unsigned (&d)[GW]) {
    unsigned pre[2 * GW], b[2 * GW];
    const int lead = xa + hx;
    const int trail = xa - hx - 1;
    const int g = w0 / GW;
    load_group<kVBits, kBits, 0>(v, plane, row + lead, lead < nx, g, nvw,
                                 pre);
    load_group<kVBits, kBits, GW>(v, plane, row + trail,
                                  trail >= 0 && trail < nx, g, nvw, pre);
    load_group<kVBits, kBits, 0>(v, plane, row + lead + 1, lead + 1 < nx, g,
                                 nvw, b);
    load_group<kVBits, kBits, GW>(v, plane, row + trail + 1,
                                  trail + 1 >= 0 && trail + 1 < nx, g, nvw,
                                  b);
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      d[i] = b[i] - b[GW + i];
      pre[i] += b[i];
      pre[GW + i] += b[GW + i];
    }
    block_scan<2 * GW>(pre, ws, [&](int i, unsigned sum) {
      const int w = w0 + (i < GW ? i : i - GW);
      if (w < nw) total[(i < GW ? 0 : nw) + w] = sum;
    });
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const int w = w0 + i;
      wb[i] = w < nw ? (carry[w] + pre[i]) - (carry[nw + w] + pre[GW + i])
                     : 0u;
    }
  };
  // the window counts at column xa + k
  auto counts = [](int k, const unsigned (&wb)[GW], const unsigned (&d)[GW],
                   unsigned (&cnt)[GW]) {
#pragma unroll
    for (int i = 0; i < GW; ++i) cnt[i] = k == 0 ? wb[i] - d[i] : wb[i];
  };

  const int group_lanes = GW * pk.lanes;
  for (int c0 = 0; c0 < nx; c0 += 2 * kWideThreads) {
    const int xa = c0 + 2 * threadIdx.x;
    qf::Cell cl[2];
    unsigned wb[GW], d[GW], cnt[GW];
    for (int w0 = 0; w0 < nw; w0 += GW) {
      window(xa, w0, wb, d);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        counts(k, wb, d, cnt);
        qf::tally<GW>(cnt, min(GW, nw - w0), w0 * pk.lanes, pk, t, q, cl[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) qf::bracket(t, cl[k]);
    if (kSingle) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        counts(k, wb, d, cnt);
        cl[k].s0 = qf::lane_count<GW>(cnt, cl[k].i0c + 1, pk);
        cl[k].s1 = qf::lane_count<GW>(cnt, cl[k].i1c + 1, pk);
      }
    } else {
      for (int w0 = 0; w0 < nw; w0 += GW) {
        const int l0 = w0 * pk.lanes;
        bool need = false;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int a0 = cl[k].i0c + 1 - l0;
          const int a1 = cl[k].i1c + 1 - l0;
          need |= xa + k < nx && cl[k].c > 0 &&
                  ((a0 >= 0 && a0 < group_lanes) ||
                   (a1 >= 0 && a1 < group_lanes));
        }
        if (!__syncthreads_or(need)) continue;
        window(xa, w0, wb, d);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int a0 = cl[k].i0c + 1 - l0;
          const int a1 = cl[k].i1c + 1 - l0;
          counts(k, wb, d, cnt);
          if (a0 >= 0 && a0 < group_lanes) {
            cl[k].s0 = qf::lane_count<GW>(cnt, a0, pk);
          }
          if (a1 >= 0 && a1 < group_lanes) {
            cl[k].s1 = qf::lane_count<GW>(cnt, a1, pk);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (xa + k < nx) out[row + xa + k] = qf::inverse_cdf(cl[k], thr, t, q);
    }
    __syncthreads();  // every scan of the chunk has left its sums in total
    for (int i = threadIdx.x; i < 2 * nw; i += kWideThreads) {
      carry[i] += total[i];
    }
    __syncthreads();
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

using Horizontal = void (*)(const unsigned*, const float*, int, const float*,
                           float*, int, int, int, int);

// quantile_horizontal for kVBits-wide vertical counts and `bits`-wide
// window counts (bits >= kVBits).
template <int kVBits, int kBits>
Horizontal horizontal_of(bool single) {
  return single ? &quantile_horizontal<kVBits, kBits, true>
                : &quantile_horizontal<kVBits, kBits, false>;
}

template <int kVBits>
Horizontal horizontal(int bits, bool single) {
  if constexpr (kVBits == 32) {
    return horizontal_of<32, 32>(single);
  } else if constexpr (kVBits == 16) {
    return bits == 32 ? horizontal_of<16, 32>(single)
                      : horizontal_of<16, 16>(single);
  } else {
    return bits == 32   ? horizontal_of<8, 32>(single)
           : bits == 16 ? horizontal_of<8, 16>(single)
                        : horizontal_of<8, 8>(single);
  }
}

int run_quantile(const float* x, float* out, unsigned* v, const float* thr,
                 int t, const float* q, int ny, int nx, int hy, int hx,
                 int device, cudaStream_t stream) {
  const long long cy = 2LL * hy + 1 < ny ? 2LL * hy + 1 : ny;
  const long long cx = 2LL * hx + 1 < nx ? 2LL * hx + 1 : nx;
  const int vbits = lane_bits(cy);
  const int bits = lane_bits(cy * cx);
  const int nvw = (t + 32 / vbits) / (32 / vbits);  // ceil((t + 1) / lanes)
  const int nw = (t + 32 / bits) / (32 / bits);
  const dim3 grid((nx + kWideThreads - 1) / kWideThreads,
                  (ny + kQRun - 1) / kQRun,
                  (nvw * (32 / vbits) + kQLanes - 1) / kQLanes);
  if (grid.y > 65535 || grid.z > 65535) return -2;
  void (*vertical)(const float*, unsigned*, const float*, int, int, int,
                   int, int) = vbits == 8    ? &quantile_vertical<8>
                               : vbits == 16 ? &quantile_vertical<16>
                                             : &quantile_vertical<32>;
  int err = prepare_launch(vertical, 0, device);
  if (err != 0) return err;
  vertical<<<grid, kWideThreads, 0, stream>>>(x, v, thr, t, ny, nx, hy, nvw);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const bool single = t + 1 <= kQGroupLanes;
  const Horizontal kernel = vbits == 8    ? horizontal<8>(bits, single)
                           : vbits == 16 ? horizontal<16>(bits, single)
                                         : horizontal<32>(bits, single);
  const size_t smem =
      sizeof(unsigned) * (4 * static_cast<size_t>(nw) +
                          kWarps * 2 * kQGroupLanes * bits / 32);
  err = prepare_launch(kernel, smem, device);
  if (err != 0) return err;
  kernel<<<ny, kWideThreads, smem, stream>>>(v, thr, t, q, out, ny, nx, hx,
                                              nw);
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
//   device f32): s0, the vertical counts, ceil((t + 1) / (32 / bits))
//   32-bit word planes, bits = lane_bits(min(2hy + 1, ny)).
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
      return run_quantile(x, out, static_cast<unsigned*>(s0), thresholds, t,
                          q, ny, nx, hy, hx, device, st);
    default:
      return -2;
  }
}

}  // extern "C"
