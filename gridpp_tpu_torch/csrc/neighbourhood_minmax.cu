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
// vector work on Mosaic and is not carried over. It runs K1's strip walk
// (stencil_strip.cuh: cp.async row ring, register folds of 8 column
// results and 8 adjacent outputs) with fminf/fmaxf in place of the adds and
// no counts. Halfwidths whose ring does not fit a block take the wide route
// (neighbourhood_wide.cu).
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_strip.cuh"

extern "C" {

// Arguments as nbm_launch (neighbourhood_mean.cu); stat is Statistic.Min or
// Statistic.Max. Returns 0, -1 when the halfwidths need more shared memory
// than the device gives a block, -2 for another statistic or a run it
// cannot take, or a cudaError_t.
int nbx_launch(const float* x, float* out, int planes, int ny, int nx,
               int hy, int hx, int bw, int rows, int stat, int device,
               void* stream) {
  using namespace strip;
  if (stat == kStatMin) {
    return launch_strip<kMin>(x, out, planes, ny, nx, hy, hx, bw, rows, stat,
                              device, stream);
  }
  if (stat == kStatMax) {
    return launch_strip<kMax>(x, out, planes, ny, nx, hy, hx, bw, rows, stat,
                              device, stream);
  }
  return -2;
}

}  // extern "C"
