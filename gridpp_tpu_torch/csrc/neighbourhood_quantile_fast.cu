// Fused threshold-CDF neighbourhood quantile for Hopper (sm_90a).
//
// Replaces gridpp_tpu/ops/pallas_stencil.py::_qf_kernel (reached through
// neighbourhood_quantile_fast). For every cell of a (Y, X) field, over a
// (2hy+1) x (2hx+1) window clipped at the domain edge:
//   c   = the number of finite cells,
//   s_k = the number of finite cells <= thresholds[k], for k < T,
//   cdf_k = f32(s_k) / f32(max(c, 1))           (IEEE division),
// then the quantile q is read off the piecewise-linear inverse CDF with
// gridpp::interpolate's flat-interval rules and the two exact-edge cases
// (neighbourhood.cpp:367-404), exactly as the plain version
// (ops/neighbourhood.py::_interp_quantile_tyx) does: the bracket comes from
// left = #{k : cdf_k < q} and right = #{k : cdf_k <= q}. NaN where c == 0
// or q is not finite.
//
// Bit for bit: s_k and c are exact integers, cdf_k is one correctly rounded
// division, the comparisons with q are the plain version's, and every
// later step is an explicitly rounded intrinsic in the plain version's
// order (no FMA contraction), so the kernel equals its plain version bit for
// bit, ties included. The TPU kernel's integer boundary `sb` with its +-1
// corrections and its bit-packed counts existed to spare the TPU's vector
// unit divisions and registers; neither is carried over.
//
// T is known only at run time and does not bound shared memory: the
// thresholds are streamed. Pass 1 runs the window count of every threshold
// and keeps, per cell, left, right, s_0 and s_{T-1}. Pass 2 recounts only
// the thresholds that some cell of the block brackets with (a block-wide
// vote), to fetch s at the two bracket indices. Counts are integer window
// sums: a vertical pass of the tile into shared memory, then a horizontal
// pass in registers.
//
// What bounds it: one f32 read and one f32 write of the field (the plain
// version writes and re-reads T planes); per threshold, the (2h+1)-term
// compares and adds run out of shared memory, so at T ~ 11-20 the kernel is
// bound by shared-memory traffic, not by device memory.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py).

#include "stencil_tile.cuh"

namespace {

using namespace stencil;

// Window count over this thread's kCells output cells (cell j is block
// cell threadIdx.x + j * kThreads) of the tile cells that satisfy pred.
// vcnt: kBY x tile_w ints of scratch.
template <class Pred>
__device__ __forceinline__ void window_counts(const float* tile, int* vcnt,
                                              int tile_w, int hy, int hx,
                                              Pred pred, int (&cnt)[kCells]) {
  const int len_y = 2 * hy + 1;
  for (int i = threadIdx.x; i < kBY * tile_w; i += kThreads) {
    const int r = i / tile_w;
    const int c = i - r * tile_w;
    const float* col = tile + r * tile_w + c;
    int n = 0;
    for (int d = 0; d < len_y; ++d) {
      n += pred(col[d * tile_w]) ? 1 : 0;
    }
    vcnt[i] = n;
  }
  __syncthreads();
  const int len_x = 2 * hx + 1;
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kBX;
    const int c = i - r * kBX;
    const int* row = vcnt + r * tile_w + c;
    int n = 0;
    for (int d = 0; d < len_x; ++d) {
      n += row[d];
    }
    cnt[j] = n;
  }
  __syncthreads();  // vcnt is rewritten by the next call
}

__global__ void __launch_bounds__(kThreads)
quantile_fast_kernel(const float* __restrict__ x,
                     const float* __restrict__ thr, int t,
                     const float* __restrict__ qp, float* __restrict__ out,
                     int ny, int nx, int hy, int hx) {
  extern __shared__ float smem[];
  const int tile_w = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                                   // raw values
  int* vcnt = reinterpret_cast<int*>(tile + tile_h * tile_w);

  load_halo_tile(x, Layout{0, nx, 1}, ny, nx, hy, hx, tile_h, tile_w, tile);
  __syncthreads();
  const float q = __ldg(qp);

  int c[kCells];
  window_counts(tile, vcnt, tile_w, hy, hx,
                [](float v) { return isfinite(v); }, c);
  float cden[kCells];
  int left[kCells], right[kCells], s_first[kCells], s_last[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    cden[j] = fmaxf(static_cast<float>(c[j]), 1.0f);
    left[j] = 0;
    right[j] = 0;
    s_first[j] = 0;
    s_last[j] = 0;
  }

  // Pass 1: where q falls among the T cdf values.
  for (int k = 0; k < t; ++k) {
    const float th = __ldg(thr + k);
    int s[kCells];
    window_counts(tile, vcnt, tile_w, hy, hx,
                  [th](float v) { return isfinite(v) && v <= th; }, s);
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const float cdf = __fdiv_rn(static_cast<float>(s[j]), cden[j]);
      left[j] += cdf < q ? 1 : 0;
      right[j] += cdf <= q ? 1 : 0;
      if (k == 0) s_first[j] = s[j];
      if (k == t - 1) s_last[j] = s[j];
    }
  }

  // The bracket (gridpp::interpolate, util.cpp:377-432).
  int i0[kCells], i1[kCells], i0c[kCells], i1c[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const bool has_exact = right[j] > left[j];
    i0[j] = has_exact ? left[j] : left[j] - 1;
    i1[j] = has_exact ? right[j] - 1 : right[j];
    i0c[j] = min(max(i0[j], 0), t - 1);
    i1c[j] = min(max(i1[j], 0), t - 1);
  }

  // Pass 2: the counts at the bracket thresholds, recounting only the
  // thresholds that a cell of this block needs.
  int s0[kCells], s1[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    s0[j] = 0;
    s1[j] = 0;
  }
  for (int k = 0; k < t; ++k) {
    bool need = false;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      need |= c[j] > 0 && (i0c[j] == k || i1c[j] == k);
    }
    if (!__syncthreads_or(need)) continue;
    const float th = __ldg(thr + k);
    int s[kCells];
    window_counts(tile, vcnt, tile_w, hy, hx,
                  [th](float v) { return isfinite(v) && v <= th; }, s);
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (i0c[j] == k) s0[j] = s[j];
      if (i1c[j] == k) s1[j] = s[j];
    }
  }

  // The inverse CDF, in _interp_quantile_tyx's order of operations.
  const float thr_first = __ldg(thr);
  const float thr_last = __ldg(thr + t - 1);
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kBX;
    const int cc = i - r * kBX;
    const int gy = blockIdx.y * kBY + r;
    const int gx = blockIdx.x * kBX + cc;
    if (gy >= ny || gx >= nx) continue;
    float y = NAN;
    if (c[j] > 0 && isfinite(q)) {
      const float x0 = __fdiv_rn(static_cast<float>(s0[j]), cden[j]);
      const float x1 = __fdiv_rn(static_cast<float>(s1[j]), cden[j]);
      const float cdf0 = __fdiv_rn(static_cast<float>(s_first[j]), cden[j]);
      const float cdft = __fdiv_rn(static_cast<float>(s_last[j]), cden[j]);
      const float y0 = __ldg(thr + i0c[j]);
      const float y1 = __ldg(thr + i1c[j]);
      const bool flat = x0 == x1;
      const float mid = __fmul_rn(__fadd_rn(y0, y1), 0.5f);  // == (y0+y1)/2
      float y_flat;
      if (i0[j] == 0 && i1[j] == t - 1) {
        y_flat = mid;
      } else if (i0[j] == 0) {
        y_flat = y1;
      } else if (i1[j] == t - 1) {
        y_flat = y0;
      } else {
        y_flat = mid;
      }
      const float dx = flat ? 1.0f : __fsub_rn(x1, x0);
      const float y_lin = __fadd_rn(
          y0, __fdiv_rn(__fmul_rn(__fsub_rn(y1, y0), __fsub_rn(q, x0)), dx));
      y = flat ? y_flat : y_lin;
      if (q > cdft) y = thr_last;
      if (q < cdf0) y = thr_first;
      // exact-edge special cases (neighbourhood.cpp:396-401)
      if (q == 1.0f && cdf0 == 1.0f) y = thr_first;
      if (q == 0.0f && cdft == 0.0f) y = thr_last;
    }
    out[static_cast<long long>(gy) * nx + gx] = y;
  }
}

}  // namespace

extern "C" {

// x, out: device pointers to (ny, nx) contiguous f32; thresholds: t > 0
// device f32; q: one device f32. stream: a cudaStream_t of `device`.
// Returns 0, -1 when the halfwidths need more shared memory than the device
// gives a block, or a cudaError_t.
int nbq_launch(const float* x, const float* thresholds, int t, const float* q,
               float* out, int ny, int nx, int hy, int hx, int device,
               void* stream) {
  const size_t smem = tile_floats(hy, hx) * sizeof(float) +
                      kBY * (kBX + 2 * static_cast<size_t>(hx)) * sizeof(int);
  const int err = prepare_launch(quantile_fast_kernel, smem, device);
  if (err != 0) return err;
  quantile_fast_kernel<<<grid_for(ny, nx, 1), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, thresholds, t, q, out, ny, nx, hy, hx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
