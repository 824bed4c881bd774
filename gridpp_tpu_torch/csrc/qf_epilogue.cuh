// The packed count lanes and the epilogue of the threshold-CDF quantile K4
// (its two passes are in neighbourhood_wide.cu: quantile_vertical,
// quantile_horizontal).
//
// K4 replaces gridpp_tpu/ops/pallas_stencil.py::_qf_kernel (reached through
// neighbourhood_quantile_fast) and stays bit for bit with its plain version,
// ops/neighbourhood.py::_quantile_fast_xla, ties included: the counts are
// exact integers, cdf_k is one correctly rounded division, the comparisons
// with q are the plain version's, and every later step is an explicitly
// rounded intrinsic in the plain version's order (no FMA contraction).
//
// Lane l of a cell counts the cells v with isfinite(v) && v <= lt_l: lt_0 =
// +inf (the finite cells), lt_k = thresholds[k - 1] for 1 <= k <= T.
// `bits`-wide lanes ride 32 / bits to a 32-bit word (ops/stencil.py::
// qf_lane_bits picks the narrowest that holds the largest count), as the
// TPU kernel packs them (pallas_stencil.py:503-531).
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

__host__ __device__ inline Packing packing(int bits) {
  return {bits, 32 / bits, bits == 32 ? 0xffffffffu : (1u << bits) - 1u};
}

// The lane thresholds of words [word0, word0 + GW): lt[4 w + p] for lane p
// of word w, NaN (counts nothing) past T and past a word's lanes.
template <int GW>
__device__ __forceinline__ void lane_thresholds(const float* __restrict__ thr,
                                                int t, int word0,
                                                const Packing& pk,
                                                float (&lt)[GW * 4]) {
#pragma unroll
  for (int w = 0; w < GW; ++w) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int l = (word0 + w) * pk.lanes + p;
      float v = NAN;
      if (p < pk.lanes) {
        if (l == 0) {
          v = INFINITY;
        } else if (l <= t) {
          v = __ldg(thr + l - 1);
        }
      }
      lt[w * 4 + p] = v;
    }
  }
}

// The GW words of one cell's indicator lanes.
template <int GW>
__device__ __forceinline__ void pack(float v, const float (&lt)[GW * 4],
                                     const Packing& pk, unsigned (&word)[GW]) {
  const bool fin = isfinite(v);
#pragma unroll
  for (int w = 0; w < GW; ++w) {
    unsigned acc = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p < pk.lanes && fin && v <= lt[w * 4 + p]) {
        acc |= 1u << (p * pk.bits);
      }
    }
    word[w] = acc;
  }
}

// Lane `l` of the words of a group (l counted from the group's first lane).
template <int GW>
__device__ __forceinline__ int lane_count(const unsigned (&acc)[GW], int l,
                                          const Packing& pk) {
  const int w = l / pk.lanes;
  const int p = l - w * pk.lanes;
  unsigned word = 0;
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    if (i == w) word = acc[i];
  }
  return static_cast<int>((word >> (p * pk.bits)) & pk.mask);
}

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
