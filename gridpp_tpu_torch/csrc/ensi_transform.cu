// The EnSI transform (ensemble OI's local ensemble transform) for Hopper
// (sm_90a): one launch takes a block of gridpoint rows from their selected
// obs to their analysed members.
//
// Replaces gridpp_tpu/ops/oi_ensi.py::_ensi_update and ::_inv_sqrt_ns, which
// are XLA there (no Pallas original), and, on the card, the port's chain of
// batched f32 products and elementwise passes that computes the same
// (ops/oi_ensi.py::_ensi_update, the plain version the CPU runs). Per
// gridpoint, from its S selected obs (an index g into the packed per-obs
// table [obs, sigma, y_hat, y_anom...], rho and validity) and its E
// background members:
//   Rinv = rho / sigma^2 on valid slots (0 elsewhere) and the innovations,
//   C = Y^T Rinv, Pinv = sym(C Y) + (E-1) I, its inf-norm bound c (1 where
//   not finite and positive), A = Pinv / c;
//   the coupled Newton-Schulz iteration on A with the schedule the caller
//   passes (ops/oi_ensi.py::_NS_COEFFS), z = sym(z);
//   w = z z C innov / c and one refinement step against Pinv (ROADMAP F6);
//   the increments sqrt((E-1)/c) (z x) + x.w, the no-extrapolation clamp
//   with the reference's count-stride quirk (oi_ensi.cpp:520-537) when
//   asked; a row with no valid obs, a non-finite Pinv or z, or a non-finite
//   analysis keeps its background, and cond_bad marks a row with a valid
//   obs whose transform was not finite.
// All in f32 on the FMA pipes: no tensor cores (TF32 operands make Pinv
// asymmetric, and the iteration diverges on asymmetric input) and no
// library.
//
// What bounds it: the FMAs. The schedule's 34 E x E products (E^3 each),
// Pinv's E^2 S and the vectors come to ~36 k FMAs a gridpoint at E = S =
// 10, against ~160 bytes of its own in device memory (g, rho, validity,
// the members in and out; the table, 520 KB for 10k obs, stays in L2):
// 1.4e11 FMAs a 2000^2 cycle, 4.3 ms at the card's 67 TFLOP/s.
//
// Design: a gridpoint's matrices never leave the SM. A group of
// G = ceil(E / R) lanes of one warp takes a gridpoint; lane k holds rows
// kR .. kR + R - 1 of each iterate in registers (R = 2 up to 16 members, 1
// above, where two rows would spill), zero-padded to EC columns (E rounded
// up to 4), so that padding never touches the real block. A product X Y
// stages Y in the group's EC x EC shared tile; each lane reads Y's rows as
// float4s that every lane of its group loads at once (a broadcast) and
// does R EC^2 FMAs, so each value loaded feeds R FMAs. A warp holds 32 / G
// gridpoints (6 at E = 10), its lanes move in lock step, so __syncwarp
// orders the tiles and one ballot gives a group's all-finite tests. The
// slot data (Y, Rinv, innovations, validity) and Pinv sit beside the tile.
//
// Plain C interface, loaded with ctypes (gridpp_tpu_torch/ops/oi_ensi.py,
// ensi_update_cuda).

#include <limits.h>
#include <stdint.h>

#include "stencil_tile.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxE = 32;      // members a row
constexpr int kMaxS = 32;      // selected obs a row
constexpr int kMaxSteps = 16;  // Newton-Schulz steps

struct Args {
  const long long* g;          // (b, s) obs index into tab
  const float* rho;            // (b, s)
  const unsigned char* valid;  // (b, s) bool
  const float* tab;            // (p, 3 + e): obs, sigma, y_hat, y_anom
  const float* bg;             // (b, e)
  float* out;                  // (b, e)
  unsigned char* cond_bad;     // (b,) bool
  long long b, p;
  int s, e;
  int allow;  // allow_extrapolation
  int fpg;    // floats of shared memory a group
  int steps;
  float coef[kMaxSteps][3];
};

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }

// A group's shared memory from its base, in floats: the EC x EC tile, the
// final Pinv (EC x EC), Y by slot (S x EC), Rinv, the innovations,
// obs - y_hat and validity (each S rounded up to 4), two EC vectors.
template <int EC>
struct Layout {
  float *tile, *pinv, *ys, *rinv, *innov, *dob, *vld, *v0, *v1;
  __device__ Layout(float* base, int s) {
    const int s4 = (s + 3) & ~3;
    tile = base;
    pinv = tile + EC * EC;
    ys = pinv + EC * EC;
    rinv = ys + s * EC;
    innov = rinv + s4;
    dob = innov + s4;
    vld = dob + s4;
    v0 = vld + s4;
    v1 = v0 + EC;
  }
};

// Floats a group takes: Layout's, rounded so that the groups of a warp
// start 4 banks apart (their broadcast float4 reads then meet no conflict).
int group_floats(int ec, int s) {
  const int s4 = (s + 3) & ~3;
  int f = 2 * ec * ec + s * ec + 4 * s4 + 2 * ec;
  f = (f + 3) & ~3;
  return f + (36 - f % 32) % 32;
}

// Writes the lane's rows of m into tile (rows row0 ..), between barriers.
template <int EC, int R>
__device__ __forceinline__ void stage(float* tile, const float (&m)[R][EC],
                                      int row0) {
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float4* dst = reinterpret_cast<float4*>(tile + (row0 + r) * EC);
#pragma unroll
    for (int j = 0; j < EC / 4; ++j) {
      dst[j] = make_float4(m[r][4 * j], m[r][4 * j + 1], m[r][4 * j + 2],
                           m[r][4 * j + 3]);
    }
  }
  __syncwarp();
}

// out = x tile: the lane's rows of the product, k ascending.
template <int EC, int R>
__device__ __forceinline__ void mul(const float (&x)[R][EC],
                                    const float* tile, float (&out)[R][EC]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < EC; ++j) out[r][j] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < EC; ++k) {
    const float4* row = reinterpret_cast<const float4*>(tile + k * EC);
#pragma unroll
    for (int j = 0; j < EC / 4; ++j) {
      const float4 v = row[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[r][4 * j] = fmaf(x[r][k], v.x, out[r][4 * j]);
        out[r][4 * j + 1] = fmaf(x[r][k], v.y, out[r][4 * j + 1]);
        out[r][4 * j + 2] = fmaf(x[r][k], v.z, out[r][4 * j + 2]);
        out[r][4 * j + 3] = fmaf(x[r][k], v.w, out[r][4 * j + 3]);
      }
    }
  }
}

// m = (m + m^T) / 2 through the tile.
template <int EC, int R>
__device__ __forceinline__ void sym(float (&m)[R][EC], float* tile,
                                    int row0) {
  stage<EC, R>(tile, m, row0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < EC; ++j) {
      m[r][j] = 0.5f * (m[r][j] + tile[j * EC + row0 + r]);
    }
  }
}

// Writes the lane's entries of a vector into v, between barriers.
template <int R>
__device__ __forceinline__ void stage_vec(float* v, const float (&u)[R],
                                          int row0) {
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) v[row0 + r] = u[r];
  __syncwarp();
}

// u = m v: the lane's rows, k ascending.
template <int EC, int R>
__device__ __forceinline__ void mv(const float (&m)[R][EC], const float* v,
                                   float (&u)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = 0.f;
#pragma unroll
  for (int j = 0; j < EC / 4; ++j) {
    const float4 q = reinterpret_cast<const float4*>(v)[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u[r] = fmaf(m[r][4 * j], q.x, u[r]);
      u[r] = fmaf(m[r][4 * j + 1], q.y, u[r]);
      u[r] = fmaf(m[r][4 * j + 2], q.z, u[r]);
      u[r] = fmaf(m[r][4 * j + 3], q.w, u[r]);
    }
  }
}

// z (z v) for the vector v of the lane's rows, through the shared vector.
template <int EC, int R>
__device__ __forceinline__ void zz(const float (&z)[R][EC], float* vec,
                                   const float (&v)[R], int row0,
                                   float (&u)[R]) {
  float t[R];
  stage_vec<R>(vec, v, row0);
  mv<EC, R>(z, vec, t);
  stage_vec<R>(vec, t, row0);
  mv<EC, R>(z, vec, u);
}

// Whether pred holds on every lane of the group (lanes in gmask); every
// lane of the warp calls it.
__device__ __forceinline__ bool group_all(bool pred, unsigned gmask) {
  return (__ballot_sync(0xffffffffu, !pred) & gmask) == 0u;
}

template <int EC, int R>
__global__ void __launch_bounds__(kThreads)
    ensi_transform_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = a.e, s = a.s;
  const int glanes = (e + R - 1) / R;  // lanes a gridpoint
  const int per_warp = 32 / glanes;    // gridpoints a warp
  const int slots = 31 / glanes + 1;   // groups a warp, the leftover too
  const int grp = lane / glanes, sub = lane - grp * glanes;
  const long long gp =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * per_warp + grp;
  const bool live = grp < per_warp && gp < a.b;
  const unsigned gmask = static_cast<unsigned>(
      ((1ull << glanes) - 1ull) << (grp * glanes));
  const int row0 = sub * R;

  float* wbase = reinterpret_cast<float*>(smem4) + warp * slots * a.fpg;
  for (int k = lane; k < slots * a.fpg; k += 32) wbase[k] = 0.f;
  __syncwarp();
  const Layout<EC> L(wbase + grp * a.fpg, s);

  // the slots: the table rows gathered here (an index outside the table
  // reads as NaN), Rinv and the innovations 0 on invalid slots
  if (live) {
    for (int t = sub; t < s; t += glanes) {
      const long long idx = gp * s + t;
      const long long gi = a.g[idx];
      const bool v = a.valid[idx] != 0;
      const bool in = gi >= 0 && gi < a.p;
      const float* row = a.tab + (in ? gi : 0) * (3 + e);
      const float ob = in ? row[0] : qnan();
      const float sg = in ? row[1] : qnan();
      const float yh = in ? row[2] : qnan();
      L.rinv[t] = v ? a.rho[idx] / (sg * sg) : 0.f;
      L.innov[t] = v ? ob - yh : 0.f;
      L.dob[t] = ob - yh;
      L.vld[t] = v ? 1.f : 0.f;
      for (int j = 0; j < e; ++j) L.ys[t * EC + j] = in ? row[3 + j] : qnan();
    }
  }
  float xb[R], x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    xb[r] = (live && i < e) ? a.bg[gp * e + i] : 0.f;
  }
  stage_vec<R>(L.v0, xb, row0);  // also orders the slots' writes
  float mean = 0.f;
  for (int k = 0; k < e; ++k) mean += L.v0[k];
  mean = mean / static_cast<float>(e);
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = row0 + r < e ? xb[r] - mean : 0.f;

  // Pinv = sym(C Y) + (E-1) I with C = Y^T Rinv, and C innov
  float p[R][EC], cv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cv[r] = 0.f;
#pragma unroll
    for (int j = 0; j < EC; ++j) p[r][j] = 0.f;
  }
  for (int t = 0; t < s; ++t) {
    const float* yrow = L.ys + t * EC;
    const float ri = L.rinv[t], in = L.innov[t];
    float c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r] = yrow[row0 + r] * ri;
      cv[r] = fmaf(c[r], in, cv[r]);
    }
#pragma unroll
    for (int j = 0; j < EC / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(yrow)[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r][4 * j] = fmaf(c[r], v.x, p[r][4 * j]);
        p[r][4 * j + 1] = fmaf(c[r], v.y, p[r][4 * j + 1]);
        p[r][4 * j + 2] = fmaf(c[r], v.z, p[r][4 * j + 2]);
        p[r][4 * j + 3] = fmaf(c[r], v.w, p[r][4 * j + 3]);
      }
    }
  }
  sym<EC, R>(p, L.tile, row0);
  const float ridge = static_cast<float>(e - 1);
  float rs[R];
  bool fin = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rs[r] = 0.f;
#pragma unroll
    for (int j = 0; j < EC; ++j) {
      if (j == row0 + r && j < e) p[r][j] += ridge;
      rs[r] += fabsf(p[r][j]);
      fin = fin && isfinite(p[r][j]);
    }
  }
  stage<EC, R>(L.pinv, p, row0);
  // c: the largest row sum of |Pinv|; 1 where that is not finite and > 0
  stage_vec<R>(L.v1, rs, row0);
  float cn = 0.f;
  bool nan = false;
  for (int k = 0; k < e; ++k) {
    const float v = L.v1[k];
    nan = nan || isnan(v);
    cn = fmaxf(cn, v);
  }
  if (nan || !isfinite(cn) || !(cn > 0.f)) cn = 1.f;

  // the coupled Newton-Schulz iteration on A = Pinv / c
  float y[R][EC], z[R][EC], t[R][EC], u[R][EC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < EC; ++j) y[r][j] = p[r][j] / cn;
  }
  for (int it = 0; it < a.steps; ++it) {
    const float ca = a.coef[it][0], cb = a.coef[it][1], cc = a.coef[it][2];
    if (it == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < EC; ++j) t[r][j] = y[r][j];
      }
    } else {
      stage<EC, R>(L.tile, y, row0);
      mul<EC, R>(z, L.tile, t);
      sym<EC, R>(t, L.tile, row0);
    }
    if (cc != 0.f) {
      stage<EC, R>(L.tile, t, row0);
      mul<EC, R>(t, L.tile, u);
    }
    // q = a I + b t [+ c t t], in t
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < EC; ++j) {
        const float id = (j == row0 + r && j < e) ? ca : 0.f;
        t[r][j] = id + cb * t[r][j];
        if (cc != 0.f) t[r][j] = t[r][j] + cc * u[r][j];
      }
    }
    if (it != a.steps - 1) {  // y is not needed after the last z update
      stage<EC, R>(L.tile, t, row0);
      mul<EC, R>(y, L.tile, u);
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < EC; ++j) y[r][j] = u[r][j];
      }
    }
    if (it == 0) {  // q I is q
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < EC; ++j) z[r][j] = t[r][j];
      }
    } else {
      stage<EC, R>(L.tile, z, row0);
      mul<EC, R>(t, L.tile, z);
    }
  }
  sym<EC, R>(z, L.tile, row0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < EC; ++j) fin = fin && isfinite(z[r][j]);
  }
  const bool cond_ok = group_all(fin, gmask);

  // w = z z C innov / c, then one refinement step against Pinv
  float w[R], res[R], dw[R];
  zz<EC, R>(z, L.v0, cv, row0, w);
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = w[r] / cn;
  stage_vec<R>(L.v0, w, row0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4* prow =
        reinterpret_cast<const float4*>(L.pinv + (row0 + r) * EC);
    float pw = 0.f;
#pragma unroll
    for (int j = 0; j < EC / 4; ++j) {
      const float4 pv = prow[j];
      const float4 wv = reinterpret_cast<const float4*>(L.v0)[j];
      pw = fmaf(pv.x, wv.x, pw);
      pw = fmaf(pv.y, wv.y, pw);
      pw = fmaf(pv.z, wv.z, pw);
      pw = fmaf(pv.w, wv.w, pw);
    }
    res[r] = cv[r] - pw;
  }
  zz<EC, R>(z, L.v0, res, row0, dw);
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = w[r] + dw[r] / cn;

  // the increments sqrt((E-1)/c) (z x) + x.w
  float zx[R], inc[R];
  stage_vec<R>(L.v0, x, row0);
  mv<EC, R>(z, L.v0, zx);
  stage_vec<R>(L.v1, w, row0);
  float xw = 0.f;
  for (int k = 0; k < e; ++k) xw = fmaf(L.v0[k], L.v1[k], xw);
  const float scale = sqrtf(ridge / cn);
#pragma unroll
  for (int r = 0; r < R; ++r) inc[r] = scale * zx[r] + xw;

  int n_valid = 0;
  for (int k = 0; k < s; ++k) n_valid += L.vld[k] != 0.f;
  if (!a.allow) {
    // the reference's clamp: member m's bound uses Y's element m of its
    // column-major flattening with the valid count as the row stride
    const int cnt = n_valid > 1 ? n_valid : 1;
    const float inf = __int_as_float(0x7f800000);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = row0 + r;
      if (m >= e) continue;
      const float ye = L.ys[(m % cnt) * EC + m / cnt];
      float hi = -inf, lo = inf;
      for (int k = 0; k < s; ++k) {
        if (L.vld[k] == 0.f) continue;
        const float d = L.dob[k] - ye;
        if (isnan(d)) continue;
        hi = fmaxf(hi, d);
        lo = fminf(lo, d);
      }
      const float mi = inc[r] - x[r];
      if (hi > 0.f && mi > hi) {
        inc[r] = hi + x[r];
      } else if (hi < 0.f && mi > 0.f) {
        inc[r] = x[r];
      } else if (lo < 0.f && mi < lo) {
        inc[r] = lo + x[r];
      } else if (lo > 0.f && mi < 0.f) {
        inc[r] = x[r];
      }
    }
  }
  float an[R];
  bool fin_a = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    an[r] = mean + inc[r];
    if (row0 + r < e) fin_a = fin_a && isfinite(an[r]);
  }
  const bool any_valid = n_valid > 0;
  const bool ok = group_all(fin_a, gmask) && cond_ok && any_valid;
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      if (i < e) a.out[gp * e + i] = ok ? an[r] : xb[r];
    }
    if (sub == 0) a.cond_bad[gp] = any_valid && !cond_ok;
  }
}

template <int EC, int R>
int launch(const Args& a, int device, cudaStream_t stream) {
  const int glanes = (a.e + R - 1) / R;
  const long long per_block = static_cast<long long>(kWarps) * (32 / glanes);
  const long long blocks = (a.b + per_block - 1) / per_block;
  if (blocks > INT_MAX) return -2;
  const size_t smem = static_cast<size_t>(kWarps) * (31 / glanes + 1) *
                      a.fpg * sizeof(float);
  const int err =
      stencil::prepare_launch(ensi_transform_kernel<EC, R>, smem, device);
  if (err != 0) return err;
  ensi_transform_kernel<EC, R><<<static_cast<unsigned>(blocks), kThreads,
                                 smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g (b, s) int64, rho (b, s) f32, valid (b, s) bool, tab (p, 3 + e) f32,
// bg and out (b, e) f32, cond_bad (b,) bool: contiguous device pointers.
// coef: `steps` host triples (a, b, c) of the Newton-Schulz schedule.
// Returns 0, -1 when the device cannot give a block the shared memory, -2
// for sizes it does not take (e or s outside 1..32, steps outside 1..16),
// or a cudaError_t.
int ens_launch(const long long* g, const float* rho,
               const unsigned char* valid, const float* tab, const float* bg,
               float* out, unsigned char* cond_bad, long long b, long long p,
               int s, int e, int allow, const float* coef, int steps,
               int device, void* stream) {
  if (e < 1 || e > kMaxE || s < 1 || s > kMaxS || steps < 1 ||
      steps > kMaxSteps || b < 0 || p < 1) {
    return -2;
  }
  if (b == 0) return 0;
  Args a{};
  a.g = g;
  a.rho = rho;
  a.valid = valid;
  a.tab = tab;
  a.bg = bg;
  a.out = out;
  a.cond_bad = cond_bad;
  a.b = b;
  a.p = p;
  a.s = s;
  a.e = e;
  a.allow = allow;
  a.steps = steps;
  for (int i = 0; i < steps; ++i) {
    for (int k = 0; k < 3; ++k) a.coef[i][k] = coef[3 * i + k];
  }
  const int ec = (e + 3) & ~3;
  a.fpg = group_floats(ec, s);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ec) {
    case 4: return launch<4, 2>(a, device, st);
    case 8: return launch<8, 2>(a, device, st);
    case 12: return launch<12, 2>(a, device, st);
    case 16: return launch<16, 2>(a, device, st);
    case 20: return launch<20, 1>(a, device, st);
    case 24: return launch<24, 1>(a, device, st);
    case 28: return launch<28, 1>(a, device, st);
    default: return launch<32, 1>(a, device, st);
  }
}

}  // extern "C"
