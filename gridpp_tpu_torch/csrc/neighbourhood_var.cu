// Fused neighbourhood Std / Variance stencil for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_var_kernel (reached through
// neighbourhood_var). For every cell, over a (2hy+1) x (2hx+1) window
// clipped at the domain edge and skipping non-finite cells, it forms the
// sum s, the sum of squares s2 and the count c, and finalizes
//   mean = s / max(c, 1), mean2 = s2 / max(c, 1)
//   Variance = mean2 - mean * mean   (unclamped, neighbourhood.cpp:211-235)
//   Std = sqrt(Variance)             (NaN where the rounding made it < 0)
// and NaN where c == 0.
//
// Rounding: every add, multiply and divide is an explicitly rounded
// intrinsic (__fadd_rn, __fmul_rn, ...), so nvcc cannot contract
// `mean2 - mean * mean` or `s2 + v * v` into an FMA: the kernel rounds
// like its plain version, the two-pass Mean form of ops/stencil.py, which
// computes x * x and mean * mean as separate rounded tensors. The sums are
// taken in another order than the plain version's, so the two agree to the
// reference's bar (rtol 2e-5, atol 2e-3), not bit for bit.
//
// What bounds it: one f32 read and one f32 write of the field, where the
// two-pass form reads it twice and writes x * x besides. A block loads its
// halo tile into shared memory (stencil_tile.cuh), then runs the vertical
// and horizontal passes for s, s2 and c together. Halfwidths whose tile
// does not fit a block take the wide route (neighbourhood_wide.cu, with the
// same rounded intrinsics); ops/stencil.py::stencil_plan decides.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_tile.cuh"

namespace {

using namespace stencil;

__global__ void __launch_bounds__(kThreads)
neighbourhood_var_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int ny, int nx, int hy, int hx,
                         bool is_std) {
  extern __shared__ float smem[];
  const int tile_w = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                    // tile_h x tile_w raw values
  float* vs = tile + tile_h * tile_w;    // kBY x tile_w vertical sums
  float* vs2 = vs + kBY * tile_w;        // ... of squares
  float* vc = vs2 + kBY * tile_w;        // ... and counts

  load_halo_tile(x, ny, nx, hy, hx, tile_h, tile_w, tile);
  __syncthreads();

  const int len_y = 2 * hy + 1;
  for (int i = threadIdx.x; i < kBY * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    float s = 0.0f;
    float s2 = 0.0f;
    float n = 0.0f;
    const float* col = tile + r * tile_w + c;
    for (int d = 0; d < len_y; ++d) {
      const float v = col[d * tile_w];
      if (isfinite(v)) {
        s = __fadd_rn(s, v);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
        n += 1.0f;
      }
    }
    vs[i] = s;
    vs2[i] = s2;
    vc[i] = n;
  }
  __syncthreads();

  const int len_x = 2 * hx + 1;
  float* ob = out + static_cast<long long>(blockIdx.z) * ny * nx;
  for (int i = threadIdx.x; i < kBY * kBX; i += kThreads) {
    const int r = i / kBX;
    const int c = i - r * kBX;
    const int gy = blockIdx.y * kBY + r;
    const int gx = blockIdx.x * kBX + c;
    if (gy >= ny || gx >= nx) continue;
    float s = 0.0f;
    float s2 = 0.0f;
    float n = 0.0f;
    const int o = r * tile_w + c;
    for (int d = 0; d < len_x; ++d) {
      s = __fadd_rn(s, vs[o + d]);
      s2 = __fadd_rn(s2, vs2[o + d]);
      n += vc[o + d];
    }
    float res = NAN;
    if (n > 0.0f) {
      const float cden = fmaxf(n, 1.0f);
      const float mean = __fdiv_rn(s, cden);
      const float mean2 = __fdiv_rn(s2, cden);
      res = __fsub_rn(mean2, __fmul_rn(mean, mean));
      if (is_std) res = __fsqrt_rn(res);
    }
    ob[static_cast<long long>(gy) * nx + gx] = res;
  }
}

}  // namespace

extern "C" {

// Arguments as nbm_launch (neighbourhood_mean.cu); stat is Statistic.Std or
// Statistic.Variance. Returns 0, -1 when the halfwidths need more shared
// memory than the device gives a block, -2 for another statistic, or a
// cudaError_t.
int nbv_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int stat, int device, void* stream) {
  if (stat != kStatStd && stat != kStatVariance) return -2;
  const size_t smem =
      (tile_floats(hy, hx) + 3 * kBY * (kBX + 2 * static_cast<size_t>(hx))) *
      sizeof(float);
  const int err = prepare_launch(neighbourhood_var_kernel, smem, device);
  if (err != 0) return err;
  neighbourhood_var_kernel<<<grid_for(ny, nx, planes), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, hy, hx, stat == kStatStd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
