// Neighbourhood Mean / Sum / Count stencil for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_mean_kernel (reached through
// neighbourhood_mean). The members of a (Y, X, E) ensemble have their own
// kernel, K5 (neighbourhood_members.cu).
// For every cell it computes the NaN-skipping sum and count over a
// (2hy+1) x (2hx+1) window clipped at the domain edge: non-finite cells add
// 0 to the sum and are left out of the count. Then
//   Mean  = s / max(c, 1), NaN where c == 0
//   Sum   = s,             NaN where c == 0
//   Count = c.
//
// What bounds it: one f32 read and one f32 write of the field (16 MB each at
// 2000 x 2000); the (2h+1)^2 adds per cell are far below the card's compute.
// The design reads each input cell from device memory about once: a block
// loads its halo tile into shared memory (stencil_tile.cuh), does the
// vertical pass into shared memory (sums and counts), then the horizontal
// pass, and writes the finalized statistic. Each pass is a direct
// (2h+1)-term sum, not a running add-and-subtract, so no error accumulates
// along a row. The planes of a batch ride on blockIdx.z.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_tile.cuh"

namespace {

using namespace stencil;

__global__ void __launch_bounds__(kThreads)
neighbourhood_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int ny, int nx, int hy, int hx,
                          int stat) {
  extern __shared__ float smem[];
  const int tile_w = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                        // tile_h x tile_w raw values
  float* vsum = tile + tile_h * tile_w;      // kBY x tile_w vertical sums
  float* vcnt = vsum + kBY * tile_w;         // kBY x tile_w vertical counts

  load_halo_tile(x, ny, nx, hy, hx, tile_h, tile_w, tile);
  __syncthreads();

  // vertical pass: (2hy+1)-term sums down each tile column.
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

  // horizontal pass over the vertical sums, then finalize.
  const int len_x = 2 * hx + 1;
  float* ob = out + static_cast<long long>(blockIdx.z) * ny * nx;
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

}  // namespace

extern "C" {

// x, out: device pointers to `planes` contiguous planes of ny x nx f32.
// stream: a cudaStream_t of `device`. Returns 0, -1 when the halfwidths need
// more shared memory than the device gives a block, or a cudaError_t.
int nbm_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int stat, int device, void* stream) {
  const size_t smem =
      (tile_floats(hy, hx) + 2 * kBY * (kBX + 2 * static_cast<size_t>(hx))) *
      sizeof(float);
  const int err = prepare_launch(neighbourhood_mean_kernel, smem, device);
  if (err != 0) return err;
  neighbourhood_mean_kernel<<<grid_for(ny, nx, planes), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      x, out, ny, nx, hy, hx, stat);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
