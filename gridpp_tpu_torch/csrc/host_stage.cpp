// Host staging of a serving cycle's arrays (api/pipeline._serve_card): one
// pass copies an array's float32 words into a pinned staging buffer and
// reports whether every value was finite, so the bytes are read from memory
// once and not twice (a finiteness pass, then the copy).
//
// The pass is split into parts of at least kMinPartWords words (a small
// array is one thread's work), one an OpenMP thread. Built with g++
// -fopenmp at first use (gridpp_tpu_torch/native/stage.py), the library
// binds to the libgomp that torch has loaded (torch's wheels carry their
// own libgomp.so.1), so the parts run on torch's intra-op threads, the ones
// that did the copy before: after a torch copy those threads still spin and
// start at once, where threads of a pool of our own had to wait for a core
// (on an H100 host, 16 MB after a 16 MB torch copy: 0.65 ms, 3.7 ms on a
// pool of its own). Called through ctypes, which releases the GIL.
#include <omp.h>
#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <cstdint>

namespace {

// 1 MiB of float32: below this an array is not split further
constexpr int64_t kMinPartWords = int64_t(1) << 18;
// parts start on a 64-byte line, so no two threads write one line
constexpr int64_t kLineWords = 16;

// Copy n words; the result has its top bit set iff some word's exponent
// bits are all ones (an Inf or a NaN): (u & 0x7f800000) + 0x00800000 reaches
// 0x80000000 only for the exponent 0xff. Every word is copied either way.
inline uint32_t copy_word(const uint32_t* src, uint32_t* dst, int64_t i) {
  const uint32_t u = src[i];
  dst[i] = u;
  return (u & 0x7f800000u) + 0x00800000u;
}

uint32_t copy_part(const uint32_t* __restrict src, uint32_t* __restrict dst,
                   int64_t n) {
  uint32_t acc = 0;
  int64_t i = 0;
#if defined(__SSE2__)
  // Streaming stores from the first 16-byte aligned word on: the buffer is
  // read next by the card's copy engine, not by this core, so its lines
  // need not be read into the cache to be written (on an H100 host: 5.6 ms
  // for 160 MB on 8 threads, 8.3 ms with plain stores).
  for (; i < n && (reinterpret_cast<uintptr_t>(dst + i) & 15) != 0; ++i)
    acc |= copy_word(src, dst, i);
  const __m128i exponent = _mm_set1_epi32(0x7f800000);
  const __m128i carry = _mm_set1_epi32(0x00800000);
  __m128i flags = _mm_setzero_si128();
  for (; i + 16 <= n; i += 16) {
    for (int k = 0; k < 16; k += 4) {
      const __m128i v =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + k));
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + k), v);
      flags = _mm_or_si128(flags,
                           _mm_add_epi32(_mm_and_si128(v, exponent), carry));
    }
  }
  _mm_sfence();   // the streamed words are visible before the part ends
  if (_mm_movemask_ps(_mm_castsi128_ps(flags)) != 0) acc |= 0x80000000u;
#endif
  for (; i < n; ++i) acc |= copy_word(src, dst, i);
  return acc & 0x80000000u;
}

}  // namespace

extern "C" {

// Copy n float32 words from src to dst on up to `threads` threads (the
// caller's included); 0 when every value is finite, 1 otherwise.
int stage_f32(const void* src, void* dst, int64_t n, int threads) {
  if (n <= 0) return 0;
  const auto* s = static_cast<const uint32_t*>(src);
  auto* d = static_cast<uint32_t*>(dst);
  int64_t parts = (n + kMinPartWords - 1) / kMinPartWords;
  if (parts > threads) parts = threads;
  if (parts <= 1) return copy_part(s, d, n) != 0;
  uint32_t bad = 0;
#pragma omp parallel num_threads(static_cast<int>(parts)) reduction(| : bad)
  {
    const int64_t team = omp_get_num_threads(), p = omp_get_thread_num();
    int64_t step = (n + team - 1) / team;
    step = (step + kLineWords - 1) / kLineWords * kLineWords;
    const int64_t lo = p * step;
    const int64_t hi = lo + step < n ? lo + step : n;
    if (lo < hi) bad |= copy_part(s + lo, d + lo, hi - lo);
  }
  return bad != 0;
}

}  // extern "C"
