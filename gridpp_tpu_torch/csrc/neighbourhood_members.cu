// Member-minor neighbourhood stencil (K5) for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_member_mean_kernel and
// ::_member_minmax_kernel (reached through neighbourhood_members). For every
// member of a (Y, X, E) f32 field it takes, over a (2hy+1) x (2hx+1) window
// of (Y, X) clipped at the domain edge, the NaN-skipping Mean, Sum or Count
// (the rules of K1, neighbourhood_mean.cu) or the Min or Max (K2,
// neighbourhood_minmax.cu).
//
// What bounds it: one f32 read and one f32 write of the whole field (160 MB
// each at 2000 x 2000 x 10). The field is read as its (Y, X*E) view, where a
// window step along x is a step of E floats. One block owns kRows x bx grid
// cells of every member, so the rows of its halo tile are contiguous runs
// of X*E: they are copied 16 bytes at a time where aligned (each tile row
// is shifted in shared memory by its global address mod 4, so the 16-byte
// slots line up) and as scalars at the edges. Threads run along the flattened (x, e) index in
// the load, in both window passes and in the store, so neighbouring
// threads touch neighbouring addresses throughout.
//
// The tile goes to shared memory by cp.async (16-byte copies, all in
// flight at once). The vertical pass gives each tile column to one thread,
// which walks down it and keeps all kRows direct (2hy+1)-term sums in
// registers (each adds its terms top to bottom), then writes them over
// the top kRows rows of its own column. The horizontal pass is a direct
// (2hx+1)-term sum per output at a stride of E floats. Where the tile
// holds no non-finite cell of the domain, the count is the clipped
// window's analytic size (as pallas_stencil.py:286-298); elsewhere a
// second walk down each column, read from device memory again, counts its
// finite cells. Each member's Mean/Sum/Count agrees with K1's on that
// member to K1's bar (K1 associates the same direct sums otherwise).
// Halfwidths where the tile of every member of one column does not fit a
// block take the wide route on the (Y, X * E) view (neighbourhood_wide.cu).
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py,
// which plans bx and the row pitch: member_plan).

#include <stdint.h>

#include "stencil_tile.cuh"

namespace {

using namespace stencil;

constexpr int kRows = 16;  // output rows per block
// blocks an SM keeps in flight at E = 10, h = 7 (~74 KB of shared memory
// each): the registers are capped to match
constexpr int kBlocksPerSm = 3;

enum Mode { kSums, kMin, kMax };

struct Block {
  int x0, y0;        // first grid column and row of the block
  int w;             // flat tile width: (bx + 2hx) * E
  long long xe;      // X * E
  long long fc0;     // flat column (x * E + e) of tile column 0
  int base;          // (address of x / 4) mod 4
  int e;             // members of the field
};

// Shared-memory slot shift of the tile row at grid row y: the row's floats
// start at this offset so that a slot's index and its global address agree
// mod 4 (16-byte vector slots).
__device__ __forceinline__ int row_shift(const Block& b, int y) {
  return static_cast<int>((b.base + static_cast<long long>(y) * b.xe + b.fc0) &
                          3);
}

// 16-byte asynchronous copy global -> shared (no register round trip, so
// every copy of the tile is in flight at once).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Loads the halo tile (rows y0 - hy .. y0 + kRows + hy) into `tile` (row r
// at tile + r * pitch + row_shift); out-of-domain cells are NaN.
__device__ void load_tile(const float* __restrict__ x, const Block& b,
                          int ny, int hy, int pitch, float* tile) {
  const int tile_h = kRows + 2 * hy;
  const int quads = (b.w + 6) / 4;  // covers shift + w for any shift
  for (int i = threadIdx.x; i < tile_h * quads; i += kThreads) {
    const int r = i / quads;
    const int q = i - r * quads;
    const int y = b.y0 - hy + r;
    const int s = row_shift(b, y);
    if (4 * q >= s + b.w) continue;
    const long long fc = b.fc0 + 4 * q - s;  // flat column of slot 4q
    const long long g = static_cast<long long>(y) * b.xe + fc;
    const bool yin = y >= 0 && y < ny;
    float* dst = tile + r * pitch + 4 * q;
    if (yin && fc >= 0 && fc + 4 <= b.xe) {
      copy16_async(dst, x + g);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dst[k] = yin && fc + k >= 0 && fc + k < b.xe ? __ldg(x + g + k) : NAN;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// Flat column (x * E + e) of tile column j, and its grid column gx (set to
// -1 outside the domain).
__device__ __forceinline__ long long column_index(const Block& b, int nx,
                                                  int hx, int j, int& gx) {
  gx = b.x0 - hx + j / b.e;
  if (gx < 0 || gx >= nx) gx = -1;
  return b.fc0 + j;
}

template <Mode kMode>
__device__ __forceinline__ float combine(float acc, float v) {
  if (kMode == kMin) return fminf(acc, v);
  if (kMode == kMax) return fmaxf(acc, v);
  return acc + v;
}

template <Mode kMode>
__device__ __forceinline__ float identity() {
  return kMode == kMin ? INFINITY : (kMode == kMax ? -INFINITY : 0.0f);
}

// Folds a tile column, read(d) being its row d, into its kRows vertical
// window results, each adding its rows top to bottom: the sums
// (or extrema) into acc, a non-finite cell adding 0 to a sum and reading as
// the identity for Min/Max; with kCounts, the finite cells into cnt
// instead. Where
// 2hy + 1 >= 8, each half of the outputs runs its rows as head (row k0 + i
// opens outputs k0 .. k0 + i), middle (every output) and tail (row
// k0 + 2hy + 1 + i closes outputs k0 + i + 1 ..), so every add is
// unconditional; below that, one predicated loop. For the sums, returns
// true when the column holds a non-finite cell of the domain.
template <Mode kMode, bool kCounts, class Read>
__device__ __forceinline__ bool fold_column(Read read, const Block& b, int ny,
                                            int hy, bool col_in,
                                            float (&acc)[kRows],
                                            int (&cnt)[kRows]) {
  const int len = 2 * hy + 1;
  const float ident = identity<kMode>();
  bool bad = false;
  auto cell = [&](int d, bool& fin) {
    const float v = read(d);  // tile row d of the column
    fin = isfinite(v);
    if (kMode == kSums && !kCounts) {
      const int y = b.y0 - hy + d;
      bad |= !fin && col_in && y >= 0 && y < ny;
    }
    return fin ? v : ident;
  };
  auto add = [&](int k, float v, bool fin) {
    if (kCounts) {
      cnt[k] += fin ? 1 : 0;
    } else {
      acc[k] = combine<kMode>(acc[k], v);
    }
  };
  if (len >= 8) {
#pragma unroll
    for (int k0 = 0; k0 < kRows; k0 += 8) {
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        bool fin;
        const float v = cell(k0 + i, fin);
#pragma unroll
        for (int r = 0; r <= i; ++r) add(k0 + r, v, fin);
      }
      for (int d = k0 + 7; d < k0 + len; ++d) {
        bool fin;
        const float v = cell(d, fin);
#pragma unroll
        for (int r = 0; r < 8; ++r) add(k0 + r, v, fin);
      }
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        bool fin;
        const float v = cell(k0 + len + i, fin);
#pragma unroll
        for (int r = i + 1; r < 8; ++r) add(k0 + r, v, fin);
      }
    }
  } else {
    for (int d = 0; d < kRows + 2 * hy; ++d) {
      bool fin;
      const float v = cell(d, fin);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (d >= k && d < k + len) add(k, v, fin);
      }
    }
  }
  return bad;
}

template <Mode kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
neighbourhood_members_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int ny, int nx, int e,
                             int hy, int hx, int bx, int pitch, int stat) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;  // (kRows + 2hy) x pitch
  // kRows x pitch vertical counts (Mean/Sum/Count; a count is <= 2hy + 1)
  unsigned short* vcnt =
      reinterpret_cast<unsigned short*>(tile + (kRows + 2 * hy) * pitch);

  Block b;
  b.x0 = blockIdx.x * bx;
  b.y0 = blockIdx.y * kRows;
  b.w = (bx + 2 * hx) * e;
  b.xe = static_cast<long long>(nx) * e;
  b.fc0 = static_cast<long long>(b.x0 - hx) * e;
  b.base = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  b.e = e;

  load_tile(x, b, ny, hy, pitch, tile);
  __syncthreads();

  // vertical pass: each thread takes whole tile columns; its sums go over
  // the top kRows rows of the column, which no other thread reads
  const int step = static_cast<int>(b.xe & 3);
  const int s_top = row_shift(b, b.y0 - hy);
  int cnt[kRows];
  bool bad = false;
  for (int j = threadIdx.x; j < b.w; j += kThreads) {
    int gx = -1;
    if (kMode == kSums) column_index(b, nx, hx, j, gx);
    float acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = identity<kMode>();
    bad |= fold_column<kMode, false>(
        [&](int d) { return tile[d * pitch + ((s_top + d * step) & 3) + j]; },
        b, ny, hy, gx >= 0, acc, cnt);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      tile[k * pitch + ((s_top + k * step) & 3) + j] = acc[k];
    }
  }
  // a tile free of non-finite cells of the domain takes the analytic
  // count; elsewhere the finite cells of each column are counted, read
  // again from device memory (the tile now holds the sums)
  const bool counted = __syncthreads_or(bad);
  if (kMode == kSums && counted) {
    for (int j = threadIdx.x; j < b.w; j += kThreads) {
      int gx;
      const long long col = column_index(b, nx, hx, j, gx);
#pragma unroll
      for (int k = 0; k < kRows; ++k) cnt[k] = 0;
      float unused[kRows];
      fold_column<kMode, true>(
          [&](int d) {
            const int y = b.y0 - hy + d;
            return gx >= 0 && y >= 0 && y < ny
                       ? __ldg(x + static_cast<long long>(y) * b.xe + col)
                       : NAN;
          },
          b, ny, hy, gx >= 0, unused, cnt);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        vcnt[k * pitch + j] = static_cast<unsigned short>(cnt[k]);
      }
    }
    __syncthreads();
  }

  // horizontal pass: each thread takes output columns o = local x * E +
  // member, down all kRows rows
  const int bxe = min(bx, nx - b.x0) * e;
  const int len_x = 2 * hx + 1;
  const int rows = min(kRows, ny - b.y0);
  for (int o = threadIdx.x; o < bxe; o += kThreads) {
    const int gx = b.x0 + o / e;
    const int cx = min(gx + hx, nx - 1) - max(gx - hx, 0) + 1;
    float* ob = out + static_cast<long long>(b.y0) * b.xe +
                static_cast<long long>(b.x0) * e + o;
    for (int k = 0; k < rows; ++k) {
      const float* row = tile + k * pitch + ((s_top + k * step) & 3) + o;
      float acc = identity<kMode>();
      for (int d = 0; d < len_x; ++d) {
        acc = combine<kMode>(acc, row[d * e]);
      }
      float res;
      if (kMode != kSums) {
        res = isfinite(acc) ? acc : NAN;
      } else {
        float n;
        if (counted) {
          int m = 0;
          const unsigned short* rc = vcnt + k * pitch + o;
          for (int d = 0; d < len_x; ++d) m += rc[d * e];
          n = static_cast<float>(m);
        } else {
          const int y = b.y0 + k;
          const int cy = min(y + hy, ny - 1) - max(y - hy, 0) + 1;
          n = static_cast<float>(cy * cx);
        }
        if (stat == kStatCount) {
          res = n;
        } else if (n > 0.0f) {
          res = stat == kStatSum ? acc : acc / fmaxf(n, 1.0f);
        } else {
          res = NAN;
        }
      }
      ob[static_cast<long long>(k) * b.xe] = res;
    }
  }
}

}  // namespace

extern "C" {

// x, out: device pointers to (ny, nx, e) contiguous f32. bx grid columns
// of every member per block, tile row pitch `pitch` floats (a multiple of
// 4, at least (bx + 2hx) * e + 3): ops/stencil.py::member_plan. stat is
// Statistic.Mean, Sum, Count, Min or Max. Returns 0, -1 when the plan needs
// more shared memory than the device gives a block, -2 for another
// statistic or a plan it cannot take, or a cudaError_t.
int nbk_launch(const float* x, float* out, int ny, int nx, int e, int hy,
               int hx, int bx, int pitch, int stat, int device,
               void* stream) {
  const long long w = static_cast<long long>(bx + 2 * hx) * e;
  if (bx < 1 || e < 1 || pitch % 4 != 0 || pitch < w + 3) {
    return -2;
  }
  void (*kernel)(const float*, float*, int, int, int, int, int, int, int,
                 int);
  size_t smem =
      (kRows + 2 * static_cast<size_t>(hy)) * pitch * sizeof(float);
  if (stat == kStatMin) {
    kernel = neighbourhood_members_kernel<kMin>;
  } else if (stat == kStatMax) {
    kernel = neighbourhood_members_kernel<kMax>;
  } else if (stat == kStatMean || stat == kStatSum || stat == kStatCount) {
    kernel = neighbourhood_members_kernel<kSums>;
    smem += kRows * static_cast<size_t>(pitch) * sizeof(unsigned short);
  } else {
    return -2;
  }
  const int err = prepare_launch(kernel, smem, device);
  if (err != 0) return err;
  const dim3 grid((nx + bx - 1) / bx, (ny + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, e, hy, hx, bx, pitch, stat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
