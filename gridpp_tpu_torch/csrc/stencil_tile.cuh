// Shared pieces of the neighbourhood stencil kernels (sm_90a): the
// statistic codes, the block size of the member-minor (Y, X, E) stencil K5
// (neighbourhood_members.cu) and prepare_launch, which K1, K2 and K3's strip
// walk (stencil_strip.cuh), K5 and the wide route (neighbourhood_wide.cu)
// call before each launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace stencil {

constexpr int kThreads = 256;  // K5's block

// Statistic values (gridpp_tpu_torch/constants.py, Statistic).
constexpr int kStatMean = 0;
constexpr int kStatMin = 10;
constexpr int kStatMax = 30;
constexpr int kStatStd = 50;
constexpr int kStatVariance = 60;
constexpr int kStatSum = 70;
constexpr int kStatCount = 80;

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
