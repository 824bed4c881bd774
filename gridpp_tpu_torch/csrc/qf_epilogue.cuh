// The epilogue of the threshold-CDF quantile K4, shared by its one-block
// kernel (neighbourhood_quantile_fast.cu) and its wide route
// (neighbourhood_wide.cu), so the two read the quantile off the same counts
// with the same instructions.
//
// From the window's count c of finite cells and s_k of finite cells <=
// thresholds[k]: cdf_k = f32(s_k) / f32(max(c, 1)) (IEEE division), the
// bracket from left = #{k : cdf_k < q} and right = #{k : cdf_k <= q}, then
// the piecewise-linear inverse CDF with gridpp::interpolate's flat-interval
// rules and the two exact-edge cases (neighbourhood.cpp:367-404), in
// ops/neighbourhood.py::_interp_quantile_tyx's order of operations, every
// step an explicitly rounded intrinsic (no FMA contraction).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace qf {

// Packed count lanes: `bits` wide, `lanes` to a 32-bit word.
struct Packing {
  int bits;       // lane width: 8, 16 or 32
  int lanes;      // lanes per word: 32 / bits
  unsigned mask;  // one lane
};

// Per-cell state of the inverse CDF.
struct Cell {
  int c = 0;           // finite cells
  float cden = 1.0f;   // f32(max(c, 1))
  int left = 0;        // #{k : cdf_k < q}
  int right = 0;       // #{k : cdf_k <= q}
  int s_first = 0;     // s_0
  int s_last = 0;      // s_{T-1}
  int i0 = 0, i1 = 0;  // the bracket, and clipped to [0, T)
  int i0c = 0, i1c = 0;
  int s0 = 0, s1 = 0;  // s at i0c and i1c
};

// Folds the lanes of a group of GW words (its first lane `lane0`; lane 0
// counts the finite cells, lane k + 1 threshold k) into the cell.
template <int GW>
__device__ __forceinline__ void tally(const unsigned (&acc)[GW], int gw,
                                      int lane0, const Packing& pk, int t,
                                      float q, Cell& cl) {
#pragma unroll
  for (int w = 0; w < GW; ++w) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int l = lane0 + w * pk.lanes + p;
      if (w < gw && p < pk.lanes && l <= t) {
        const int s = static_cast<int>((acc[w] >> (p * pk.bits)) & pk.mask);
        if (l == 0) {
          cl.c = s;
          cl.cden = fmaxf(static_cast<float>(s), 1.0f);
        } else {
          const float cdf = __fdiv_rn(static_cast<float>(s), cl.cden);
          cl.left += cdf < q ? 1 : 0;
          cl.right += cdf <= q ? 1 : 0;
          if (l == 1) cl.s_first = s;
          if (l == t) cl.s_last = s;
        }
      }
    }
  }
}

// The bracket (gridpp::interpolate, util.cpp:377-432).
__device__ __forceinline__ void bracket(int t, Cell& cl) {
  const bool has_exact = cl.right > cl.left;
  cl.i0 = has_exact ? cl.left : cl.left - 1;
  cl.i1 = has_exact ? cl.right - 1 : cl.right;
  cl.i0c = min(max(cl.i0, 0), t - 1);
  cl.i1c = min(max(cl.i1, 0), t - 1);
}

// The inverse CDF, in _interp_quantile_tyx's order of operations.
__device__ __forceinline__ float inverse_cdf(const Cell& cl,
                                             const float* __restrict__ thr,
                                             int t, float q) {
  if (cl.c <= 0 || !isfinite(q)) return NAN;
  const float x0 = __fdiv_rn(static_cast<float>(cl.s0), cl.cden);
  const float x1 = __fdiv_rn(static_cast<float>(cl.s1), cl.cden);
  const float cdf0 = __fdiv_rn(static_cast<float>(cl.s_first), cl.cden);
  const float cdft = __fdiv_rn(static_cast<float>(cl.s_last), cl.cden);
  const float y0 = __ldg(thr + cl.i0c);
  const float y1 = __ldg(thr + cl.i1c);
  const bool flat = x0 == x1;
  const float mid = __fmul_rn(__fadd_rn(y0, y1), 0.5f);  // == (y0+y1)/2
  float y_flat;
  if (cl.i0 == 0 && cl.i1 == t - 1) {
    y_flat = mid;
  } else if (cl.i0 == 0) {
    y_flat = y1;
  } else if (cl.i1 == t - 1) {
    y_flat = y0;
  } else {
    y_flat = mid;
  }
  const float dx = flat ? 1.0f : __fsub_rn(x1, x0);
  const float y_lin = __fadd_rn(
      y0, __fdiv_rn(__fmul_rn(__fsub_rn(y1, y0), __fsub_rn(q, x0)), dx));
  float y = flat ? y_flat : y_lin;
  if (q > cdft) y = __ldg(thr + t - 1);
  if (q < cdf0) y = __ldg(thr);
  // exact-edge special cases (neighbourhood.cpp:396-401)
  if (q == 1.0f && cdf0 == 1.0f) y = __ldg(thr);
  if (q == 0.0f && cdft == 0.0f) y = __ldg(thr + t - 1);
  return y;
}

}  // namespace qf
