// Neighbourhood Std / Variance stencil for Hopper (sm_90a).
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
// two-pass form reads it twice and writes x * x besides. The design is K1's
// strip walk (stencil_strip.cuh, mode kVar): a block walks a strip of up to
// 128 tile-row floats down a run of rows in chunks of 16, the next chunk's
// rows arriving by cp.async into a ring; the vertical pass folds the pair
// (v, v * v) of 8 outputs a thread, sharing the window's core, the
// horizontal pass 8 adjacent outputs (registers for hx <= 8), once for the
// sums and once for the squares; a chunk with no NaN takes the analytic
// count. A leading axis of planes (EnsiPipeline's (E, Y, X) members) rides
// in the same launch. Halfwidths past the crossover take the wide route
// (neighbourhood_wide.cu, with the same rounded intrinsics);
// ops/stencil.py::stencil_plan decides.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_strip.cuh"

extern "C" {

// Arguments as nbm_launch (neighbourhood_mean.cu: `planes` planes, the
// strip width bw and the run of rows from ops/stencil.py::strip_plan); stat
// is Statistic.Std or Statistic.Variance. Returns 0, -1 when the halfwidths
// need more shared memory than the device gives a block, -2 for another
// statistic or a run it cannot take, or a cudaError_t.
int nbv_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int bw, int rows, int stat, int device,
               void* stream) {
  using namespace strip;
  if (stat != kStatStd && stat != kStatVariance) return -2;
  return launch_strip<kVar>(x, out, planes, ny, nx, hy, hx, bw, rows, stat,
                            device, stream);
}

}  // extern "C"
