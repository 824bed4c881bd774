// Shared pieces of the neighbourhood stencil kernels (sm_90a).
//
// Every stencil kernel of the package works the same way: one block of
// kThreads threads owns a kBY x kBX patch of output cells, loads the
// (kBY + 2hy) x (kBX + 2hx) halo tile around it into shared memory, and
// then runs a vertical and a horizontal window pass over the tile. Cells
// outside the domain are read as NaN, which every kernel treats as missing:
// that gives the window clipped at the domain edge without any index
// arithmetic in the passes.
//
// A plane is addressed through a Layout, so one kernel serves both a
// contiguous (B, Y, X) batch (plane = Y*X, row = X, col = 1) and the
// member-minor (Y, X, E) layout of an ensemble (plane = 1, row = X*E,
// col = E): blockIdx.z picks the plane.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace stencil {

constexpr int kBY = 32;        // output rows per block
constexpr int kBX = 64;        // output columns per block
constexpr int kThreads = 256;
constexpr int kCells = kBY * kBX / kThreads;  // output cells per thread

// Statistic values (gridpp_tpu_torch/constants.py, Statistic).
constexpr int kStatMin = 10;
constexpr int kStatMax = 30;
constexpr int kStatStd = 50;
constexpr int kStatVariance = 60;
constexpr int kStatSum = 70;
constexpr int kStatCount = 80;

// Element (y, x) of plane b lies at base[b * plane + y * row + x * col].
struct Layout {
  long long plane;
  long long row;
  long long col;
};

// Halo tile of this block's patch of plane blockIdx.z -> `tile`
// (tile_h x tile_w, row-major); out-of-domain cells are NaN.
__device__ inline void load_halo_tile(const float* __restrict__ x,
                                      const Layout& lay, int ny, int nx,
                                      int hy, int hx, int tile_h, int tile_w,
                                      float* tile) {
  const float* xb = x + blockIdx.z * lay.plane;
  const int y0 = blockIdx.y * kBY - hy;  // absolute row of tile row 0
  const int x0 = blockIdx.x * kBX - hx;  // absolute column of tile col 0
  for (int i = threadIdx.x; i < tile_h * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    const int gy = y0 + r;
    const int gx = x0 + c;
    float v = NAN;
    if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      v = xb[gy * lay.row + gx * lay.col];
    }
    tile[i] = v;
  }
}

inline size_t tile_floats(int hy, int hx) {
  return (kBY + 2 * static_cast<size_t>(hy)) *
         (kBX + 2 * static_cast<size_t>(hx));
}

inline dim3 grid_for(int ny, int nx, int planes) {
  return dim3((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY, planes);
}

// Makes `device` current and lets `kernel` take `smem` bytes of dynamic
// shared memory. Returns 0, -1 when the device cannot give a block that
// much, or the cudaError_t that failed.
template <class Kernel>
int prepare_launch(Kernel kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(limit)) return -1;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  return static_cast<int>(err);
}

}  // namespace stencil
