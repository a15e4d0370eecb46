// The DSD coders' payload reader and byte renormalisation, shared by
// dsd_fast.cu (mode 1, one warp a lane) and dsd_high.cu (mode 3, one
// thread a lane).
//
// A lane's payload is its row of the (L, NB) uint8 tensor, NB a multiple
// of 4, so the row is whole aligned 32-bit words. The coder takes bytes
// in stream order, most significant first, from a 64-bit register window
// holding the next 4 to 8 bytes; a refill appends one byte-swapped word.
// Every word load is clamped to the row's last word, so no read leaves
// the row whatever the lane's byte count says; bytes at or past the
// lane's count sit in the window but never enter the coder's value (the
// renormalisation takes at most the bytes left, the mult == 0 reload only
// when 4 are left), so the padding past a lane's bytes is never read as
// data, as in the plain version, which reads only `nbytes`.

#pragma once

#include <cstdint>

namespace dsd {

__device__ __forceinline__ uint32_t bswap(uint32_t v) {
  return __byte_perm(v, 0, 0x0123);
}

// One thread's word source: the next word, loaded one refill ahead.
struct ThreadWords {
  const uint32_t* w;
  int last, next;
  uint32_t ahead;

  __device__ __forceinline__ uint32_t load(int i) const {
    return __ldg(w + (i < last ? i : last));
  }
  __device__ __forceinline__ void start(const uint32_t* row, int nwords) {
    w = row;
    last = nwords - 1;
    next = 0;
    ahead = load(0);
  }
  __device__ __forceinline__ uint32_t take() {
    const uint32_t v = ahead;
    ahead = load(++next);
    return v;
  }
};

// A warp's word source (mode 1: the 32 threads of a warp decode one
// lane): thread i holds word 32k + i of the row and word 32(k + 1) + i,
// so a refill is one shuffle and each coalesced load is issued 32 words
// ahead of its use. Every thread must call take() together.
struct WarpWords {
  const uint32_t* w;
  int last, next, lid;
  uint32_t cur, ahead;

  __device__ __forceinline__ uint32_t load(int i) const {
    return __ldg(w + (i < last ? i : last));
  }
  __device__ __forceinline__ void start(const uint32_t* row, int nwords,
                                        int thread) {
    w = row;
    last = nwords - 1;
    next = 0;
    lid = thread;
    cur = load(lid);
    ahead = load(32 + lid);
  }
  __device__ __forceinline__ uint32_t take() {
    const uint32_t v = __shfl_sync(0xFFFFFFFFu, cur, next & 31);
    if ((++next & 31) == 0) {
      cur = ahead;
      ahead = load(next + 32 + lid);
    }
    return v;
  }
};

// The next bytes of the stream, most significant first: `nbytes` (4 to 8
// between calls) valid bytes at the top of `bits`.
template <class Words>
struct Window {
  Words src;
  uint64_t bits;
  int nbytes;

  __device__ __forceinline__ void fill() {
    const uint64_t hi = bswap(src.take());
    bits = (hi << 32) | bswap(src.take());
    nbytes = 8;
  }
  // The next 4 bytes as one big-endian word; then k (0 to 4) of them are
  // consumed.
  __device__ __forceinline__ uint32_t consume(int k) {
    const uint32_t top = (uint32_t)(bits >> 32);
    bits <<= 8 * k;
    nbytes -= k;
    if (nbytes < 4) {
      bits |= (uint64_t)bswap(src.take()) << (32 - 8 * nbytes);
      nbytes += 4;
    }
    return top;
  }
};

// The reference's loop `while (((high ^ low) & 0xFF000000) == 0 && bytes
// left)` (DsdUtils.cs:295-300, :476-481) runs exactly clz(high ^ low) >> 3
// times (each pass lowers the clz by 8), at most the bytes left; the k
// bytes shift in at once (a funnel shift of 32 bits takes the whole word:
// k == 4 gives value = the 4 bytes, high = ~0, low = 0). No branch but
// the window's refill.
template <class W>
__device__ __forceinline__ void renorm(uint32_t& high, uint32_t& low,
                                       uint32_t& value, int& bptr, W& win,
                                       int nb) {
  int k = __clz((int)(high ^ low)) >> 3;
  const int left = max(0, min(nb - bptr, 4));
  k = min(k, left);
  const uint32_t top = win.consume(k);
  const int sh = 8 * k;
  value = __funnelshift_lc(top, value, sh);
  high = __funnelshift_lc(0xFFFFFFFFu, high, sh);
  low = __funnelshift_lc(0u, low, sh);
  bptr += k;
}

}  // namespace dsd
