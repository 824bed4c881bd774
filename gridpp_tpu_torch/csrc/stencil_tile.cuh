// Shared pieces of the neighbourhood stencil kernels (sm_90a).
//
// K3 (neighbourhood_var.cu) and K4 (neighbourhood_quantile_fast.cu) work
// the same way: one block of kThreads threads owns a kBY x kBX patch of
// output cells, loads the (kBY + 2hy) x (kBX + 2hx) halo tile around it
// into shared memory, and then runs a vertical and a horizontal window pass
// over the tile. Cells outside the domain are read as NaN, which every
// kernel treats as missing: that gives the window clipped at the domain
// edge without any index arithmetic in the passes. A leading axis of planes
// (a contiguous (B, Y, X) batch) rides on blockIdx.z.
//
// K1 and K2 walk strips instead (stencil_strip.cuh), the member-minor
// (Y, X, E) stencil K5 has its own tiling (neighbourhood_members.cu), and
// the wide route (neighbourhood_wide.cu) reads device memory directly; they
// share the statistic codes and prepare_launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace stencil {

constexpr int kBY = 32;        // output rows per block
constexpr int kBX = 64;        // output columns per block
constexpr int kThreads = 256;

// Statistic values (gridpp_tpu_torch/constants.py, Statistic).
constexpr int kStatMean = 0;
constexpr int kStatMin = 10;
constexpr int kStatMax = 30;
constexpr int kStatStd = 50;
constexpr int kStatVariance = 60;
constexpr int kStatSum = 70;
constexpr int kStatCount = 80;

// Halo tile of this block's patch of plane blockIdx.z of a contiguous
// (planes, ny, nx) field -> `tile` (tile_h x tile_w, row-major);
// out-of-domain cells are NaN.
__device__ inline void load_halo_tile(const float* __restrict__ x, int ny,
                                      int nx, int hy, int hx, int tile_h,
                                      int tile_w, float* tile) {
  const float* xb = x + static_cast<long long>(blockIdx.z) * ny * nx;
  const int y0 = blockIdx.y * kBY - hy;  // absolute row of tile row 0
  const int x0 = blockIdx.x * kBX - hx;  // absolute column of tile col 0
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
}

inline size_t tile_floats(int hy, int hx) {
  return (kBY + 2 * static_cast<size_t>(hy)) *
         (kBX + 2 * static_cast<size_t>(hx));
}

inline dim3 grid_for(int ny, int nx, int planes) {
  return dim3((nx + kBX - 1) / kBX, (ny + kBY - 1) / kBY, planes);
}

// What a library has granted each (kernel, device): the device's opt-in
// shared-memory limit and the largest dynamic shared memory set so far.
struct SmemGrant {
  const void* kernel;
  int device;
  int limit;
  size_t granted;
};
constexpr int kMaxGrants = 64;

inline std::mutex& grant_mutex() {
  static std::mutex m;
  return m;
}

inline SmemGrant* find_grant(const void* kernel, int device) {
  static SmemGrant grants[kMaxGrants];
  static int n = 0;
  for (int i = 0; i < n; ++i) {
    if (grants[i].kernel == kernel && grants[i].device == device) {
      return &grants[i];
    }
  }
  if (n == kMaxGrants) return nullptr;
  grants[n] = SmemGrant{kernel, device, -1, 0};
  return &grants[n++];
}

// Makes `device` current (only when it is not) and lets `kernel` take
// `smem` bytes of dynamic shared memory. The device's limit and the
// attribute are cached per (kernel, device): the attribute is set again
// only to grow it. Returns 0, -1 when the device cannot give a block that
// much, or the cudaError_t that failed.
template <class Kernel>
int prepare_launch(Kernel kernel, size_t smem, int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  std::lock_guard<std::mutex> lock(grant_mutex());
  SmemGrant fresh{nullptr, device, -1, 0};
  SmemGrant* g = find_grant(reinterpret_cast<const void*>(kernel), device);
  if (g == nullptr) g = &fresh;  // table full: query and set every time
  if (g->limit < 0) {
    err = cudaDeviceGetAttribute(
        &g->limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) {
      g->limit = -1;
      return static_cast<int>(err);
    }
  }
  if (smem > static_cast<size_t>(g->limit)) return -1;
  if (smem > g->granted) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    g->granted = smem;
  }
  return 0;
}

}  // namespace stencil
