// Neighbourhood Mean / Sum / Count stencil for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_mean_kernel (reached through
// neighbourhood_mean). For every cell it computes the NaN-skipping sum and
// count over a (2hy+1) x (2hx+1) window clipped at the domain edge:
// non-finite cells add 0 to the sum and are left out of the count. Then
//   Mean  = s / max(c, 1), NaN where c == 0
//   Sum   = s,             NaN where c == 0
//   Count = c.
//
// What bounds it: one f32 read and one f32 write of the field (16 MB each at
// 2000 x 2000); the (2h+1)^2 adds per cell are far below the card's compute.
// The design reads each input cell from device memory about once: a block
// loads its (BY + 2hy) x (BX + 2hx) halo tile into shared memory (cells
// outside the domain are read as NaN, which gives the clipped window), does
// the vertical pass into shared memory (sums and counts), then the
// horizontal pass, and writes the finalized statistic. Each pass is a
// direct (2h+1)-term sum, not a running add-and-subtract, so no error
// accumulates along a row. A leading batch axis (B, Y, X) rides on
// blockIdx.z; 2-D callers pass B = 1.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBY = 32;        // output rows per block
constexpr int kBX = 64;        // output columns per block
constexpr int kThreads = 256;

constexpr int kStatSum = 70;   // Statistic.Sum
constexpr int kStatCount = 80; // Statistic.Count; any other stat is Mean

__global__ void __launch_bounds__(kThreads)
neighbourhood_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int ny, int nx, int hy, int hx, int stat) {
  extern __shared__ float smem[];
  const int tile_w = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                        // tile_h x tile_w raw values
  float* vsum = tile + tile_h * tile_w;      // kBY x tile_w vertical sums
  float* vcnt = vsum + kBY * tile_w;         // kBY x tile_w vertical counts

  const long long plane = static_cast<long long>(ny) * nx;
  const float* xb = x + blockIdx.z * plane;
  float* ob = out + blockIdx.z * plane;
  const int y0 = blockIdx.y * kBY - hy;      // absolute row of tile row 0
  const int x0 = blockIdx.x * kBX - hx;      // absolute column of tile col 0

  // 1. halo tile -> shared memory; consecutive threads read consecutive
  //    columns of one row, so the loads coalesce.
  for (int i = threadIdx.x; i < tile_h * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    const int gy = y0 + r;
    const int gx = x0 + c;
    float v = NAN;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      v = xb[static_cast<long long>(gy) * nx + gx];
    }
    tile[i] = v;
  }
  __syncthreads();

  // 2. vertical pass: (2hy+1)-term sums down each tile column.
  const int len_y = 2 * hy + 1;
  for (int i = threadIdx.x; i < kBY * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    float s = 0.0f;
    float n = 0.0f;
    const float* col = tile + r * tile_w + c;
    for (int d = 0; d < len_y; ++d) {
      const float v = col[d * tile_w];
      if (isfinite(v)) {
        s += v;
        n += 1.0f;
      }
    }
    vsum[i] = s;
    vcnt[i] = n;
  }
  __syncthreads();

  // 3. horizontal pass over the vertical sums, then finalize.
  const int len_x = 2 * hx + 1;
  for (int i = threadIdx.x; i < kBY * kBX; i += kThreads) {
    const int r = i / kBX;
    const int c = i - r * kBX;
    const int gy = blockIdx.y * kBY + r;
    const int gx = blockIdx.x * kBX + c;
    if (gy >= ny || gx >= nx) continue;
    float s = 0.0f;
    float n = 0.0f;
    const float* rs = vsum + r * tile_w + c;
    const float* rc = vcnt + r * tile_w + c;
    for (int d = 0; d < len_x; ++d) {
      s += rs[d];
      n += rc[d];
    }
    float res;
    if (stat == kStatCount) {
      res = n;
    } else if (n > 0.0f) {
      res = stat == kStatSum ? s : s / fmaxf(n, 1.0f);
    } else {
      res = NAN;
    }
    ob[static_cast<long long>(gy) * nx + gx] = res;
  }
}

size_t smem_bytes(int hy, int hx) {
  const size_t tile_w = kBX + 2 * static_cast<size_t>(hx);
  const size_t tile_h = kBY + 2 * static_cast<size_t>(hy);
  return (tile_h * tile_w + 2 * kBY * tile_w) * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs for halfwidths (hy, hx).
size_t nbm_smem_bytes(int hy, int hx) { return smem_bytes(hy, hx); }

// The most dynamic shared memory a block may opt in to on `device`, or -1.
int nbm_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// x, out: device pointers to (b, ny, nx) contiguous f32. stream: a
// cudaStream_t of `device`. Returns the cudaError_t of the launch (0 = ok).
int nbm_launch(const float* x, float* out, int b, int ny, int nx, int hy,
               int hx, int stat, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = smem_bytes(hy, hx);
  err = cudaFuncSetAttribute(neighbourhood_mean_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY, b);
  neighbourhood_mean_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, hy, hx, stat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
