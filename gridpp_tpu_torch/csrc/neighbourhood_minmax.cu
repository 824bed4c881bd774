// Neighbourhood Min / Max stencil for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_minmax_kernel (reached through
// neighbourhood_minmax). The members of a (Y, X, E) ensemble have their own
// kernel, K5 (neighbourhood_members.cu).
// For every cell it takes the Min or Max over a (2hy+1) x (2hx+1) window
// clipped at the domain edge. Non-finite cells are missing: they read as
// the identity (+inf for Min, -inf for Max), and a window with no finite
// cell, whose result stays at the identity, gives NaN.
//
// Min and Max are exact in any order of evaluation, so the kernel equals
// its plain PyTorch version (ops/stencil.py) bit for bit.
//
// What bounds it: like K1 (neighbourhood_mean.cu), one f32 read and one f32
// write of the field; the TPU kernel's dilated doubling existed to save
// vector work on Mosaic and is not carried over. A block loads its halo
// tile into shared memory (stencil_tile.cuh), takes the (2hy+1)-term
// vertical extremum into shared memory, then the horizontal one.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_tile.cuh"

namespace {

using namespace stencil;

template <bool kMax>
__device__ __forceinline__ float pick(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
neighbourhood_minmax_kernel(const float* __restrict__ x,
                            float* __restrict__ out, int ny, int nx,
                            int hy, int hx) {
  extern __shared__ float smem[];
  const int tile_w = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                    // tile_h x tile_w raw values
  float* vext = tile + tile_h * tile_w;  // kBY x tile_w vertical extrema
  const float ident = kMax ? -INFINITY : INFINITY;

  load_halo_tile(x, ny, nx, hy, hx, tile_h, tile_w, tile);
  __syncthreads();

  const int len_y = 2 * hy + 1;
  for (int i = threadIdx.x; i < kBY * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    float e = ident;
    const float* col = tile + r * tile_w + c;
    for (int d = 0; d < len_y; ++d) {
      const float v = col[d * tile_w];
      e = pick<kMax>(e, isfinite(v) ? v : ident);
    }
    vext[i] = e;
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
    float e = ident;
    const float* row = vext + r * tile_w + c;
    for (int d = 0; d < len_x; ++d) {
      e = pick<kMax>(e, row[d]);
    }
    ob[static_cast<long long>(gy) * nx + gx] = isfinite(e) ? e : NAN;
  }
}

}  // namespace

extern "C" {

// Arguments as nbm_launch (neighbourhood_mean.cu); stat is Statistic.Min or
// Statistic.Max. Returns 0, -1 when the halfwidths need more shared memory
// than the device gives a block, -2 for another statistic, or a cudaError_t.
int nbx_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int stat, int device, void* stream) {
  if (stat != kStatMin && stat != kStatMax) return -2;
  const size_t smem =
      (tile_floats(hy, hx) + kBY * (kBX + 2 * static_cast<size_t>(hx))) *
      sizeof(float);
  void (*kernel)(const float*, float*, int, int, int, int) =
      neighbourhood_minmax_kernel<false>;
  if (stat == kStatMax) kernel = neighbourhood_minmax_kernel<true>;
  const int err = prepare_launch(kernel, smem, device);
  if (err != 0) return err;
  kernel<<<grid_for(ny, nx, planes), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, hy, hx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
