// The strip-walking window stencil of K1 (Mean/Sum/Count), K2 (Min/Max)
// and K3 (Std/Variance) for Hopper (sm_90a).
//
// A block owns a strip of `bw` output columns of one plane and walks down a
// run of `rows` output rows (ops/stencil.py::strip_plan sets bw so that the
// tile row, bw + 2hx, is at most kStripW floats where it can, and the run
// so the grid is about one wave of the card's SMs). It works the run in
// chunks of kChunk output rows:
//
// - Loads. The input rows of a chunk (kChunk + 2hy rows of bw + 2hx
//   columns) sit in a ring of 2 kChunk + 2hy rows in shared memory. While a
//   chunk is summed, the kChunk rows the next chunk adds are already on
//   their way by cp.async (two commit groups in flight). Where X is a
//   multiple of 4, the block's ring rows are shifted by their global address
//   mod 4 (the same for every row), so whole quads go by 16-byte copies;
//   elsewhere, and at the edges, cells go by 4-byte copies, and cells
//   outside the domain are written as NaN, which clips the window.
// - Vertical pass. With a tile row of at most kStripW floats, the
//   2 (bw + 2hx) vertical tasks take one round of the block's threads. A
//   thread takes half a tile column (kHalf outputs) and
//   folds its kHalf + 2hy input rows into kHalf direct (2hy+1)-term results
//   held in registers: each input cell is read from shared memory about
//   (kHalf + 2hy) / kHalf times, not 2hy + 1 times. Each result adds its
//   rows top to bottom. K3 folds the pair (v, v * v) of each cell in one
//   walk.
// - Horizontal pass. A thread takes kOut adjacent outputs of one row: for
//   hx <= kHCap it reads the kOut + 2hx vertical results it needs with
//   16-byte shared loads into registers and forms every output from them,
//   each a direct (2hx+1)-term result; above the cap it folds them as the
//   vertical pass does, reading shared memory per term (about (kOut + 2hx)
//   / kOut reads an output), from rows of an odd pitch so that a warp's
//   tasks spread over the banks. K3 folds its sums and its sums of squares
//   one after the other. Outputs are stored 32 bytes a thread where
//   aligned.
// - Counts (K1, K3). A chunk whose ring rows hold no non-finite cell of the
//   domain takes the clipped window's analytic size (a block vote with
//   __syncthreads_or); otherwise a second vertical fold counts the finite
//   cells and the horizontal pass sums them the same way.
//
// Rounding (K3): every add of its folds is __fadd_rn and its squares
// __fmul_rn, so nvcc contracts nothing into an FMA; every result is still a
// direct (2h+1)-term sum, head + core + tail, never a running add and
// subtract.
//
// What bounds it: one f32 read and one f32 write of the field; the halo
// (2hy / rows of the rows, 2hx / kStripW of the columns) is read again,
// mostly from L2.

#pragma once

#include <stdint.h>

#include "stencil_tile.cuh"

namespace strip {

using namespace stencil;

constexpr int kChunk = 16;     // output rows of a chunk
constexpr int kHalf = 8;       // output rows of one vertical fold
constexpr int kStripW = 128;   // tile row floats of one round of tasks
constexpr int kOut = 8;        // adjacent outputs of a horizontal task
constexpr int kHCap = 8;       // largest hx of the register horizontal pass
constexpr int kStripThreads = 256;
constexpr int kStripBlocksPerSm = 3;
static_assert(kChunk * kStripW / kOut == kStripThreads,
              "bw <= kStripW: one horizontal task a thread");
static_assert(2 * kStripW == kStripThreads, "tw <= kStripW: one vertical "
              "round");
static_assert(kChunk == 2 * kHalf, "two vertical folds per column");
static_assert(kOut == kHalf, "fold_half folds kOut outputs");

// K1's sums, K2's extrema, K3's sums with explicitly rounded adds
enum Mode { kSums, kMin, kMax, kVar };

// Planes of kChunk x v_pitch vertical results a block keeps: K2 its
// extrema, K1 its sums and counts, K3 its sums, sums of squares and counts.
__host__ __device__ constexpr int result_planes(Mode m) {
  return m == kVar ? 3 : (m == kSums ? 2 : 1);
}

__host__ __device__ inline int ceil4(int v) { return (v + 3) & ~3; }
// floats of a ring row: the tile row plus room for its shift
__host__ __device__ inline int ring_pitch(int bw, int hx) {
  return ceil4(bw + 2 * hx + 3);
}
__host__ __device__ inline int ring_rows(int hy) { return 2 * kChunk + 2 * hy; }
// floats of a row of vertical results: the tile row, and at least the
// kOut + 2 kHCap floats the last register task reads. Above the cap the
// pitch is odd: a warp's horizontal tasks read kOut-strided columns of
// several rows at once, and with a pitch of a multiple of 8 floats those
// rows fall on the same banks (8-way conflicts; 2-3 way when odd).
__host__ __device__ inline int v_pitch(int bw, int hx) {
  return hx > kHCap ? (bw + 2 * hx) | 1 : ceil4(bw + 2 * kHCap);
}
// Bytes of dynamic shared memory: the ring, then `planes` planes of
// kChunk x v_pitch vertical results (result_planes).
inline size_t strip_smem(int bw, int hy, int hx, int planes) {
  return sizeof(float) *
         (static_cast<size_t>(ring_rows(hy)) * ring_pitch(bw, hx) +
          static_cast<size_t>(planes) * kChunk * v_pitch(bw, hx));
}

template <Mode kMode>
__device__ __forceinline__ float identity() {
  return kMode == kMin ? INFINITY : (kMode == kMax ? -INFINITY : 0.0f);
}

template <Mode kMode>
__device__ __forceinline__ float combine(float acc, float v) {
  if (kMode == kMin) return fminf(acc, v);
  if (kMode == kMax) return fmaxf(acc, v);
  if (kMode == kVar) return __fadd_rn(acc, v);
  return acc + v;
}

// K3's partial result of a cell or a window: the sum and the sum of squares.
struct Pair {
  float s, s2;
};

__device__ __forceinline__ Pair add_rn(Pair a, Pair b) {
  return {__fadd_rn(a.s, b.s), __fadd_rn(a.s2, b.s2)};
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_older_groups() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Folds the terms cell(0 .. kHalf + len - 2) of a column into kHalf direct
// len-term results with `op`, output r taking terms r .. r + len - 1. Where
// len >= kHalf every output holds the core terms kHalf - 1 .. len - 1,
// which are folded once; output r is then (head r .. kHalf - 2, folded from
// the bottom up) with the core, then (tail len .. len + r - 1, folded top
// down): about 2 kHalf + len operations for the kHalf outputs instead of
// kHalf len, and still a direct sum of the window (no running
// add-and-subtract), in another association. Below that, one predicated
// loop into acc, which the caller sets to `ident`. cell() is called once
// per term.
template <class V, class Cell, class Op>
__device__ __forceinline__ void fold_half(Cell cell, Op op, V ident, int len,
                                          V (&acc)[kHalf]) {
  if (len >= kHalf) {
    V head[kHalf];  // head[r]: terms r .. kHalf - 2
    head[kHalf - 1] = ident;
    head[kHalf - 2] = cell(kHalf - 2);
#pragma unroll
    for (int r = kHalf - 3; r >= 0; --r) head[r] = op(cell(r), head[r + 1]);
    V core = cell(kHalf - 1);
    for (int d = kHalf; d < len; ++d) core = op(core, cell(d));
    V tail = ident;  // terms len .. len + r - 1
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      acc[r] = r == kHalf - 1 ? op(core, tail) : op(op(head[r], core), tail);
      if (r < kHalf - 1) tail = r == 0 ? cell(len) : op(tail, cell(len + r));
    }
  } else {
    for (int d = 0; d < len + kHalf - 1; ++d) {
      const V v = cell(d);
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        if (d >= r && d < r + len) acc[r] = op(acc[r], v);
      }
    }
  }
}

// kOut adjacent direct (2HX+1)-term results from registers v (v[c] for
// tile column c), with fold_half's core / head / tail association where
// the window is at least kOut wide, else term by term left to right.
template <int HX, class Op>
__device__ __forceinline__ void fold_row_fixed(
    const float (&v)[kOut + 2 * kHCap], Op op, float ident,
    float (&res)[kOut]) {
  constexpr int kLen = 2 * HX + 1;
  if constexpr (kLen >= kOut) {
    float head[kOut];
    head[kOut - 1] = ident;
    head[kOut - 2] = v[kOut - 2];
#pragma unroll
    for (int j = kOut - 3; j >= 0; --j) head[j] = op(v[j], head[j + 1]);
    float core = v[kOut - 1];
#pragma unroll
    for (int d = kOut; d < kLen; ++d) core = op(core, v[d]);
    float tail = ident;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      res[j] = j == 0 ? op(head[0], core)
                      : (j == kOut - 1 ? op(core, tail)
                                       : op(op(head[j], core), tail));
      if (j < kOut - 1) tail = j == 0 ? v[kLen] : op(tail, v[kLen + j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      float acc = v[j];
#pragma unroll
      for (int d = 1; d < kLen; ++d) acc = op(acc, v[j + d]);
      res[j] = acc;
    }
  }
}

// kOut adjacent direct (2hx+1)-term horizontal results, combined as kMode
// combines (counts: kSums), from a row of vertical results (row[c] for
// tile column c). For hx <= kHCap the row is read by 16-byte loads into
// registers and folded by the variant for hx; above it, fold_half's
// shared-core fold reads shared memory once per term, about 2 kOut + 2hx
// reads for the kOut outputs. The vertical results are finite or the
// identity, and are folded as they are.
template <Mode kMode>
__device__ __forceinline__ void fold_row(const float* row, int hx,
                                         float (&res)[kOut]) {
  auto op = [](float a, float b) { return combine<kMode>(a, b); };
  const float ident = identity<kMode>();
  if (hx <= kHCap) {
    float v[kOut + 2 * kHCap];
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < (kOut + 2 * kHCap) / 4; ++q) {
      const float4 f = row4[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
    switch (hx) {
      case 0: fold_row_fixed<0>(v, op, ident, res); break;
      case 1: fold_row_fixed<1>(v, op, ident, res); break;
      case 2: fold_row_fixed<2>(v, op, ident, res); break;
      case 3: fold_row_fixed<3>(v, op, ident, res); break;
      case 4: fold_row_fixed<4>(v, op, ident, res); break;
      case 5: fold_row_fixed<5>(v, op, ident, res); break;
      case 6: fold_row_fixed<6>(v, op, ident, res); break;
      case 7: fold_row_fixed<7>(v, op, ident, res); break;
      default: fold_row_fixed<kHCap>(v, op, ident, res); break;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kOut; ++j) res[j] = ident;
    fold_half<float>([row](int d) { return row[d]; }, op, ident, 2 * hx + 1,
                     res);
  }
}

template <Mode kMode>
__global__ void __launch_bounds__(kStripThreads, kStripBlocksPerSm)
strip_kernel(const float* __restrict__ x, float* __restrict__ out, int ny,
             int nx, int hy, int hx, int bw, int rows, int stat) {
  constexpr bool kCounted = kMode == kSums || kMode == kVar;
  extern __shared__ __align__(16) float smem[];
  const int pitch = ring_pitch(bw, hx);
  const int rr = ring_rows(hy);
  const int vp = v_pitch(bw, hx);
  const int tw = bw + 2 * hx;
  float* ring = smem;
  float* vres = ring + rr * pitch;   // kChunk x vp vertical results
  float* vres2 = vres + kChunk * vp;  // ... of squares (K3)
  // kChunk x vp vertical counts (K1, K3): the last plane
  float* vcnt = vres + (result_planes(kMode) - 1) * kChunk * vp;

  const int strips = (nx + bw - 1) / bw;
  const int runs = (ny + rows - 1) / rows;
  const int strip = blockIdx.x % strips;
  const int run = (blockIdx.x / strips) % runs;
  const int plane = blockIdx.x / (strips * runs);
  const int x0 = strip * bw;
  const int xs = x0 - hx;  // global column of tile column 0
  const int y0 = run * rows;
  const int y1 = min(y0 + rows, ny);
  const long long pbase = static_cast<long long>(plane) * ny * nx;
  const float* xp = x + pbase;
  float* op = out + pbase;
  const long long obase = (reinterpret_cast<uintptr_t>(out) >> 2) & 3;
  // 16-byte copies where every row starts at the same address mod 4: tile
  // column c then sits at slot c + shift of its ring row
  const bool quads = (nx & 3) == 0;
  const int shift =
      quads ? static_cast<int>(
                  ((reinterpret_cast<uintptr_t>(x) >> 2) + pbase + xs) & 3)
            : 0;
  // input rows [ya, yb) into their ring rows (row y at (y - y0 + hy) % rr)
  auto load_rows = [&](int ya, int yb) {
    const int per_row = quads ? (shift + tw + 3) / 4 : tw;
    const int n = (yb - ya) * per_row;
    for (int i = threadIdx.x; i < n; i += kStripThreads) {
      const int r = i / per_row;
      const int q = i - r * per_row;
      const int y = ya + r;
      float* dst = ring + ((y - y0 + hy) % rr) * pitch;
      const float* src = xp + static_cast<long long>(y) * nx;
      const bool yin = y >= 0 && y < ny;
      if (quads) {
        const int gx = xs + 4 * q - shift;  // global column of slot 4q
        if (yin && gx >= 0 && gx + 4 <= nx) {
          copy16_async(dst + 4 * q, src + gx);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (yin && gx + k >= 0 && gx + k < nx) {
              copy4_async(dst + 4 * q + k, src + gx + k);
            } else {
              dst[4 * q + k] = NAN;
            }
          }
        }
      } else {
        const int gx = xs + q;
        if (yin && gx >= 0 && gx < nx) {
          copy4_async(dst + q, src + gx);
        } else {
          dst[q] = NAN;
        }
      }
    }
  };
  // column c of fold task (half, c): its rows from the ring, fold row d in
  // ring row slot0 + d, less rr from d = wrap on
  auto column = [&](int yc, int task, int& c, int& k0) {
    const int half = task >= tw;
    c = task - half * tw;
    k0 = half * kHalf;
    const int slot0 = (yc - hy + k0 - y0 + hy) % rr;
    const int wrap = rr - slot0;
    const float* col = ring + shift + c + slot0 * pitch;
    const int back = rr * pitch;
    return [col, wrap, back, pitch](int d) {
      return col[d * pitch - (d >= wrap ? back : 0)];
    };
  };

  const int nchunks = (y1 - y0 + kChunk - 1) / kChunk;
  const int len_y = 2 * hy + 1;
  const int groups = (bw + kOut - 1) / kOut;  // horizontal tasks per row
  load_rows(y0 - hy, y0 + kChunk + hy);
  commit_group();
  for (int ci = 0; ci < nchunks; ++ci) {
    const int yc = y0 + ci * kChunk;
    if (ci + 1 < nchunks) {
      load_rows(yc + kChunk + hy, yc + 2 * kChunk + hy);
    }
    commit_group();
    wait_older_groups();  // this chunk's rows have landed
    __syncthreads();

    // vertical pass: task = (half, tile column), columns fastest
    bool bad = false;
    for (int task = threadIdx.x; task < 2 * tw; task += kStripThreads) {
      int c, k0;
      const auto read = column(yc, task, c, k0);
      int nonfinite = 0;
      if constexpr (kMode == kVar) {
        Pair acc[kHalf];
#pragma unroll
        for (int r = 0; r < kHalf; ++r) acc[r] = Pair{0.0f, 0.0f};
        fold_half<Pair>(
            [&](int d) {
              const float v = read(d);
              const bool fin = isfinite(v);
              nonfinite += !fin;
              return fin ? Pair{v, __fmul_rn(v, v)} : Pair{0.0f, 0.0f};
            },
            [](Pair a, Pair b) { return add_rn(a, b); }, Pair{0.0f, 0.0f},
            len_y, acc);
#pragma unroll
        for (int r = 0; r < kHalf; ++r) {
          vres[(k0 + r) * vp + c] = acc[r].s;
          vres2[(k0 + r) * vp + c] = acc[r].s2;
        }
      } else {
        float acc[kHalf];
#pragma unroll
        for (int r = 0; r < kHalf; ++r) acc[r] = identity<kMode>();
        fold_half<float>(
            [&](int d) {
              const float v = read(d);
              const bool fin = isfinite(v);
              nonfinite += !fin;
              return fin ? v : identity<kMode>();
            },
            [](float a, float b) { return combine<kMode>(a, b); },
            identity<kMode>(), len_y, acc);
#pragma unroll
        for (int r = 0; r < kHalf; ++r) vres[(k0 + r) * vp + c] = acc[r];
      }
      if (kCounted) {
        // the fold read rows ytop .. ytop + kHalf + 2hy - 1 of column c; its
        // NaN padding: every row outside the domain, or all of them
        const int ytop = yc - hy + k0;
        const int n_rows = kHalf + 2 * hy;
        const int pad = xs + c >= 0 && xs + c < nx
                            ? n_rows - max(0, min(ytop + n_rows, ny) -
                                                  max(ytop, 0))
                            : n_rows;
        bad |= nonfinite > pad;
      }
    }
    bool counted = false;
    if (kCounted) {
      counted = __syncthreads_or(bad);
      if (counted) {
        for (int task = threadIdx.x; task < 2 * tw; task += kStripThreads) {
          int c, k0;
          const auto read = column(yc, task, c, k0);
          float cnt[kHalf];
#pragma unroll
          for (int r = 0; r < kHalf; ++r) cnt[r] = 0.0f;
          fold_half<float>(
              [&](int d) { return isfinite(read(d)) ? 1.0f : 0.0f; },
              [](float a, float b) { return a + b; }, 0.0f, len_y, cnt);
#pragma unroll
          for (int r = 0; r < kHalf; ++r) vcnt[(k0 + r) * vp + c] = cnt[r];
        }
      }
    }
    __syncthreads();

    // horizontal pass and store: row k, outputs c0 .. c0 + kOut - 1
    for (int task = threadIdx.x; task < kChunk * groups;
         task += kStripThreads) {
      const int k = task / groups;
      const int c0 = (task - k * groups) * kOut;
      const int y = yc + k;
      const int valid = min(min(kOut, bw - c0), nx - x0 - c0);
      if (y >= y1 || valid <= 0) continue;
      float res[kOut];
      fold_row<kMode>(vres + k * vp + c0, hx, res);
      if (kCounted) {
        float n[kOut];
        if (counted) {
          fold_row<kSums>(vcnt + k * vp + c0, hx, n);
        } else {
          const int cy = min(y + hy, ny - 1) - max(y - hy, 0) + 1;
          const int gx0 = x0 + c0;
          if (gx0 >= hx && gx0 + kOut - 1 + hx < nx) {  // no column clipped
            const float nn = static_cast<float>(cy * (2 * hx + 1));
#pragma unroll
            for (int j = 0; j < kOut; ++j) n[j] = nn;
          } else {
#pragma unroll
            for (int j = 0; j < kOut; ++j) {
              const int gx = gx0 + j;
              const int cx = min(gx + hx, nx - 1) - max(gx - hx, 0) + 1;
              n[j] = static_cast<float>(cy * cx);
            }
          }
        }
        if constexpr (kMode == kVar) {
          float res2[kOut];
          fold_row<kVar>(vres2 + k * vp + c0, hx, res2);
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            float v = NAN;
            if (n[j] > 0.0f) {
              // Variance = E[x^2] - E[x]^2, unclamped (neighbourhood.cpp:
              // 211-235); Std is NaN where the rounding left it below 0
              const float cden = fmaxf(n[j], 1.0f);
              const float mean = __fdiv_rn(res[j], cden);
              const float mean2 = __fdiv_rn(res2[j], cden);
              v = __fsub_rn(mean2, __fmul_rn(mean, mean));
              if (stat == kStatStd) v = __fsqrt_rn(v);
            }
            res[j] = v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            float v;
            if (stat == kStatCount) {
              v = n[j];
            } else if (n[j] > 0.0f) {
              // IEEE division: the plain K4 smooths its indicator planes
              // with this Mean and must stay bit for bit with K4
              v = stat == kStatSum ? res[j] : res[j] / fmaxf(n[j], 1.0f);
            } else {
              v = NAN;
            }
            res[j] = v;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          res[j] = isfinite(res[j]) ? res[j] : NAN;
        }
      }
      const long long o = static_cast<long long>(y) * nx + x0 + c0;
      if (valid == kOut && ((obase + pbase + o) & 3) == 0) {
        float4* dst = reinterpret_cast<float4*>(op + o);
        dst[0] = make_float4(res[0], res[1], res[2], res[3]);
        dst[1] = make_float4(res[4], res[5], res[6], res[7]);
      } else {
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          if (j < valid) op[o + j] = res[j];
        }
      }
    }
  }
  // no cp.async is left in flight: the last chunk committed an empty group
  // and waited for the one before it
}

// Launches strip_kernel<kMode> over `planes` planes with strips of `bw`
// output columns (a positive multiple of kOut, at most kStripW) and runs
// of `rows` output rows (a positive multiple of kChunk). Returns 0, -1 when
// the plan needs more shared memory than the device gives a block, -2 for
// a strip or run it cannot take, or a cudaError_t.
template <Mode kMode>
int launch_strip(const float* x, float* out, int planes, int ny, int nx,
                 int hy, int hx, int bw, int rows, int stat, int device,
                 void* stream) {
  if (rows < kChunk || rows % kChunk != 0 || bw < kOut || bw > kStripW ||
      bw % kOut != 0) {
    return -2;
  }
  const size_t smem = strip_smem(bw, hy, hx, result_planes(kMode));
  const int err = prepare_launch(strip_kernel<kMode>, smem, device);
  if (err != 0) return err;
  const long long blocks = static_cast<long long>((nx + bw - 1) / bw) *
                           ((ny + rows - 1) / rows) * planes;
  if (blocks > 0x7fffffffLL) return -2;
  strip_kernel<kMode><<<static_cast<unsigned>(blocks), kStripThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, hy, hx, bw, rows, stat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace strip
