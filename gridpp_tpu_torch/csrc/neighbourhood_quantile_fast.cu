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
// or q is not finite. Thresholds need not be sorted.
//
// Bit for bit: s_k and c are exact integers, cdf_k is one correctly rounded
// division, the comparisons with q are the plain version's, and every
// later step is an explicitly rounded intrinsic in the plain version's
// order (no FMA contraction), so the kernel equals its plain version bit for
// bit, ties included.
//
// Packed counts, as the TPU kernel packs them (pallas_stencil.py:503-531):
// lane 0 counts the finite cells and lane k + 1 the cells <= thresholds[k];
// `bits`-wide lanes (8 while the window has <= 255 cells, 16 while <=
// 65535, else 32: ops/stencil.py::qf_lane_bits) ride 32 / bits to an int32
// word. A lane's window sum never exceeds the window size, so plain int32
// adds and subtracts never carry into the next lane, and being exact they
// may run: each window pass adds the cell entering and subtracts the one
// leaving, O(1) per cell and word instead of O(2h+1).
//
// A block loads its halo tile of floats once (stencil_tile.cuh). A group of
// up to GW words is then formed on the fly from the tile: the vertical pass
// keeps running sums down column segments into shared memory, the
// horizontal pass running sums along row segments in registers. Where every
// word of a cell fits one group (T = 11 at 8 bits is 3 words), one pass
// gives every s_k: left, right, the bracket and s at its two ends come from
// registers (kSingle). For larger T the groups are streamed: pass 1 keeps
// left, right, s_0 and s_{T-1} per cell, and pass 2 recounts only the
// groups holding a threshold that some cell of the block brackets with (a
// block-wide vote). Outputs are staged in shared memory and stored as rows.
//
// What bounds it: one f32 read and one f32 write of the field (the plain
// version writes and re-reads T planes); on chip, the T + 1 compares per
// tile cell, the packed running sums in shared memory and T divisions per
// output cell.
//
// The epilogue (tally, bracket, inverse_cdf) lives in qf_epilogue.cuh,
// which the wide route (neighbourhood_wide.cu) shares. Halfwidths whose
// tile does not fit a block take that route (ops/stencil.py::stencil_plan).
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/stencil.py,
// which plans the lanes, the group and the pitch: qf_plan).

#include "qf_epilogue.cuh"
#include "stencil_tile.cuh"

namespace {

using namespace stencil;
using namespace qf;

constexpr int kSegY = 16;  // rows per vertical-pass task
constexpr int kSegX = 8;   // output columns per thread in the horizontal pass
constexpr int kOutPitch = kBX + 1;  // staged outputs, conflict-free by row
static_assert(kBY == 2 * kSegY, "two vertical segments per column");
static_assert((kBX / kSegX) * kBY == kThreads, "one row segment a thread");

// Floats of shared memory before the vertical sums: the halo tile, which
// the staged outputs overwrite once it has been read (at h = 0 the staging
// is the larger).
__host__ __device__ inline int tile_area(int hy, int hx) {
  const int tile = (kBY + 2 * hy) * (kBX + 2 * hx);
  return tile > kBY * kOutPitch ? tile : kBY * kOutPitch;
}

// Lane l of a cell counts the tile cells v with isfinite(v) && v <= lt:
// lt = +inf for lane 0 (the finite cells), thresholds[l - 1] for 1 <= l <=
// t, NaN past T (nothing). Fills the lane thresholds of words [word0,
// word0 + GW).
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

// The window sums of words [word0, word0 + gw) of every output cell of the
// block: a vertical pass of running sums down kSegY-row segments of each
// tile column into vs (GW planes of kBY x vp), then a horizontal pass of
// running sums along this thread's kSegX cells of row threadIdx.x % kBY,
// calling visit(j, acc) for its j-th cell. Ends with a barrier.
template <int GW, class Visit>
__device__ __forceinline__ void window_words(
    const float* tile, unsigned* vs, int tw, int vp, int hy, int hx,
    const float* __restrict__ thr, int t, int word0, int gw,
    const Packing& pk, Visit visit) {
  float lt[GW * 4];
  lane_thresholds<GW>(thr, t, word0, pk, lt);
  const int plane = kBY * vp;
  for (int task = threadIdx.x; task < 2 * tw; task += kThreads) {
    const int c = task % tw;
    const int r0 = (task / tw) * kSegY;
    unsigned acc[GW], wd[GW];
#pragma unroll
    for (int w = 0; w < GW; ++w) acc[w] = 0;
    for (int d = 0; d <= 2 * hy; ++d) {
      pack<GW>(tile[(r0 + d) * tw + c], lt, pk, wd);
#pragma unroll
      for (int w = 0; w < GW; ++w) acc[w] += wd[w];
    }
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      if (w < gw) vs[w * plane + r0 * vp + c] = acc[w];
    }
    for (int r = r0 + 1; r < r0 + kSegY; ++r) {
      pack<GW>(tile[(r + 2 * hy) * tw + c], lt, pk, wd);
#pragma unroll
      for (int w = 0; w < GW; ++w) acc[w] += wd[w];
      pack<GW>(tile[(r - 1) * tw + c], lt, pk, wd);
#pragma unroll
      for (int w = 0; w < GW; ++w) {
        acc[w] -= wd[w];
        if (w < gw) vs[w * plane + r * vp + c] = acc[w];
      }
    }
  }
  __syncthreads();

  const int x0 = (threadIdx.x / kBY) * kSegX;
  const unsigned* row = vs + (threadIdx.x % kBY) * vp + x0;
  unsigned acc[GW];
#pragma unroll
  for (int w = 0; w < GW; ++w) {
    acc[w] = 0;
    if (w < gw) {
      for (int d = 0; d <= 2 * hx; ++d) acc[w] += row[w * plane + d];
    }
  }
  visit(0, acc);
#pragma unroll
  for (int j = 1; j < kSegX; ++j) {
#pragma unroll
    for (int w = 0; w < GW; ++w) {
      if (w < gw) {
        acc[w] += row[w * plane + j + 2 * hx] - row[w * plane + j - 1];
      }
    }
    visit(j, acc);
  }
  __syncthreads();  // vs is rewritten by the next group
}

template <int GW, bool kSingle>
__global__ void __launch_bounds__(kThreads)
quantile_fast_kernel(const float* __restrict__ x,
                     const float* __restrict__ thr, int t,
                     const float* __restrict__ qp, float* __restrict__ out,
                     int ny, int nx, int hy, int hx, int bits, int nw,
                     int vp) {
  extern __shared__ __align__(16) float smem[];
  const int tw = kBX + 2 * hx;
  const int tile_h = kBY + 2 * hy;
  float* tile = smem;                                          // raw values
  unsigned* vs = reinterpret_cast<unsigned*>(tile + tile_area(hy, hx));
  float* stage = smem;  // kBY x kOutPitch outputs, over the finished tile

  load_halo_tile(x, ny, nx, hy, hx, tile_h, tw, tile);
  __syncthreads();
  const float q = __ldg(qp);
  const Packing pk{bits, 32 / bits,
                   bits == 32 ? 0xffffffffu : (1u << bits) - 1u};
  const int r = threadIdx.x % kBY;
  const int xs = (threadIdx.x / kBY) * kSegX;

  if (kSingle) {
    // every word in one group: the whole inverse CDF from registers (the
    // horizontal pass reads only vs, so the outputs may overwrite the tile)
    window_words<GW>(
        tile, vs, tw, vp, hy, hx, thr, t, 0, nw, pk,
        [&](int j, const unsigned (&acc)[GW]) {
          Cell cl;
          tally<GW>(acc, nw, 0, pk, t, q, cl);
          bracket(t, cl);
          cl.s0 = lane_count<GW>(acc, cl.i0c + 1, pk);
          cl.s1 = lane_count<GW>(acc, cl.i1c + 1, pk);
          stage[r * kOutPitch + xs + j] = inverse_cdf(cl, thr, t, q);
        });
  } else {
    Cell cells[kSegX];
    const int group_lanes = GW * pk.lanes;
    for (int w0 = 0; w0 < nw; w0 += GW) {
      window_words<GW>(tile, vs, tw, vp, hy, hx, thr, t, w0,
                       min(GW, nw - w0), pk,
                       [&](int j, const unsigned (&acc)[GW]) {
                         tally<GW>(acc, min(GW, nw - w0), w0 * pk.lanes, pk,
                                   t, q, cells[j]);
                       });
    }
#pragma unroll
    for (int j = 0; j < kSegX; ++j) bracket(t, cells[j]);
    // pass 2: s at the bracket ends, recounting only the groups a cell of
    // this block needs
    for (int w0 = 0; w0 < nw; w0 += GW) {
      const int lo = w0 * pk.lanes;
      const int hi = lo + group_lanes;
      bool need = false;
#pragma unroll
      for (int j = 0; j < kSegX; ++j) {
        const int l0 = cells[j].i0c + 1;
        const int l1 = cells[j].i1c + 1;
        need |= cells[j].c > 0 &&
                ((l0 >= lo && l0 < hi) || (l1 >= lo && l1 < hi));
      }
      if (!__syncthreads_or(need)) continue;
      window_words<GW>(tile, vs, tw, vp, hy, hx, thr, t, w0,
                       min(GW, nw - w0), pk,
                       [&](int j, const unsigned (&acc)[GW]) {
                         const int l0 = cells[j].i0c + 1;
                         const int l1 = cells[j].i1c + 1;
                         if (l0 >= lo && l0 < hi) {
                           cells[j].s0 = lane_count<GW>(acc, l0 - lo, pk);
                         }
                         if (l1 >= lo && l1 < hi) {
                           cells[j].s1 = lane_count<GW>(acc, l1 - lo, pk);
                         }
                       });
    }
    __syncthreads();  // the last reads of the tile are done
#pragma unroll
    for (int j = 0; j < kSegX; ++j) {
      stage[r * kOutPitch + xs + j] = inverse_cdf(cells[j], thr, t, q);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kBY * kBX; i += kThreads) {
    const int rr = i / kBX;
    const int cc = i - rr * kBX;
    const int gy = blockIdx.y * kBY + rr;
    const int gx = blockIdx.x * kBX + cc;
    if (gy < ny && gx < nx) {
      out[static_cast<long long>(gy) * nx + gx] = stage[rr * kOutPitch + cc];
    }
  }
}

}  // namespace

extern "C" {

// x, out: device pointers to (ny, nx) contiguous f32; thresholds: t > 0
// device f32; q: one device f32. bits: the lane width (8, 16 or 32); nw:
// the packed words of a cell, ceil((t + 1) / (32 / bits)); gw: the words of
// a group (1, 2 or 4; one pass where nw <= gw); vp: the pitch of the
// vertical sums, >= kBX + 2hx (ops/stencil.py::qf_plan).
// stream: a cudaStream_t of `device`. Returns 0, -1 when the plan needs
// more shared memory than the device gives a block, -2 for a bad plan, or
// a cudaError_t.
int nbq_launch(const float* x, const float* thresholds, int t, const float* q,
               float* out, int ny, int nx, int hy, int hx, int bits, int nw,
               int gw, int vp, int device, void* stream) {
  const int tw = kBX + 2 * hx;
  if ((bits != 8 && bits != 16 && bits != 32) || vp < tw ||
      nw != (t + 32 / bits) / (32 / bits)) {
    return -2;
  }
  const bool single = nw <= gw;
  void (*kernel)(const float*, const float*, int, const float*, float*, int,
                 int, int, int, int, int, int);
  if (gw == 4) {
    kernel = single ? &quantile_fast_kernel<4, true>
                    : &quantile_fast_kernel<4, false>;
  } else if (gw == 2) {
    kernel = single ? &quantile_fast_kernel<2, true>
                    : &quantile_fast_kernel<2, false>;
  } else if (gw == 1) {
    kernel = single ? &quantile_fast_kernel<1, true>
                    : &quantile_fast_kernel<1, false>;
  } else {
    return -2;
  }
  const size_t smem =
      (tile_area(hy, hx) + static_cast<size_t>(gw) * kBY * vp) *
      sizeof(float);
  const int err = prepare_launch(kernel, smem, device);
  if (err != 0) return err;
  kernel<<<grid_for(ny, nx, 1), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(x, thresholds, t, q, out, ny,
                                                nx, hy, hx, bits, nw, vp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
