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
// The design (stencil_strip.cuh): a block walks a strip of up to 128
// columns (112 at h=7, so the tile row is 128 floats) down a
// run of rows in chunks of 16, with the next chunk's rows arriving by
// cp.async while the current one is summed; the vertical pass keeps 8 column
// sums in registers and the horizontal pass 8 adjacent outputs, so each
// input is read from shared memory a few times rather than 2h+1; a chunk
// with no NaN takes the analytic count. Each pass is a direct (2h+1)-term
// sum, not a running add-and-subtract, so no error accumulates along a row.
// Halfwidths whose ring does not fit a block take the wide route
// (neighbourhood_wide.cu); ops/stencil.py::stencil_plan decides.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_strip.cuh"

extern "C" {

// x, out: device pointers to `planes` contiguous planes of ny x nx f32.
// bw: output columns of a block's strip, a positive multiple of 8, at most
// 128; rows: output rows a block walks, a positive multiple of 16
// (ops/stencil.py::strip_plan). stat is Statistic.Mean, Sum or Count.
// stream: a cudaStream_t of `device`. Returns 0, -1 when the halfwidths need
// more shared memory than the device gives a block, -2 for another
// statistic or a run it cannot take, or a cudaError_t.
int nbm_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int bw, int rows, int stat, int device,
               void* stream) {
  using namespace strip;
  if (stat != kStatMean && stat != kStatSum && stat != kStatCount) return -2;
  return launch_strip<kSums>(x, out, planes, ny, nx, hy, hx, bw, rows, stat,
                             device, stream);
}

}  // extern "C"
