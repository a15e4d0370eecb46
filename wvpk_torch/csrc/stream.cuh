// Bit-level helpers shared by the kernels that read a lane's staged
// bitstream (entropy.cu, wvc.cu, wvx.cu) and by the encode word coders
// (encode_bits.cuh): C#'s int32 wrap, shifts with defined overflow, a
// 64-bit window over the lane's 32-bit words (Stream::peek), the register
// bit reader (BitBuf, entropy.cu and wvc.cu), and the median updates.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wvpk {

__device__ __forceinline__ long long wrap32(long long x) {
  return (long long)(int32_t)(uint32_t)(uint64_t)x;
}

// x << n in two's complement, defined for negative x (n in 0..63).
__device__ __forceinline__ long long shl(long long x, long long n) {
  return (long long)((uint64_t)x << n);
}

// Consecutive low 1-bits of a window (64 if all ones).
__device__ __forceinline__ long long trailing_ones(uint64_t win) {
  uint64_t y = ~win;
  return y == 0 ? 64 : (long long)(__ffsll((long long)y) - 1);
}

// Low n bits of the window, n clamped to 0..63.
__device__ __forceinline__ long long bits_of(uint64_t win, long long n) {
  if (n <= 0) return 0;
  if (n > 63) n = 63;
  return (long long)(win & ((1ull << n) - 1));
}

// bit_length of a value, 0 for x <= 0 (count_bits, WordsUtils.cs:513).
__device__ __forceinline__ long long bit_length(long long x) {
  return x > 0 ? 64 - __clzll(x) : 0;
}

// The median updates (WordsUtils.cs:433-475) with divisor 2^SH: the int64
// form of the plain version, and its 32-bit form for int32 medians. With
// m = q 2^SH + r (q = m >> SH, 0 <= r < 2^SH), (m + 2^SH) >> SH is
// exactly q + 1 and (m + 2^SH - 2) >> SH is q + ((r + 2^SH - 2) >> SH);
// q, and q + 1 times 5 or 2, fit int32, and the int64 sum truncated to
// int32 (wrap32) is the sum in 32-bit unsigned arithmetic.
template <int SH>
__device__ __forceinline__ long long med_inc(long long m) {
  return wrap32(m + ((m + (1LL << SH)) >> SH) * 5);
}
template <int SH>
__device__ __forceinline__ long long med_dec(long long m) {
  return wrap32(m - ((m + (1LL << SH) - 2) >> SH) * 2);
}
template <int SH>
__device__ __forceinline__ int med_inc(int m) {
  return (int)((unsigned)m + (unsigned)(((m >> SH) + 1) * 5));
}
template <int SH>
__device__ __forceinline__ int med_dec(int m) {
  const int q = (m >> SH) + (((m & ((1 << SH) - 1)) + (1 << SH) - 2) >> SH);
  return (int)((unsigned)m - (unsigned)(q * 2));
}

struct Stream {
  const uint32_t* words;  // this lane's row of the (L, W) array
  int nwords;
  long long max_bit;      // positions past the last word clamp to its start

  __device__ __forceinline__ Stream(const uint32_t* row, int w)
      : words(row), nwords(w), max_bit((long long)(w - 1) * 32) {}

  // >= 33 valid low bits of the stream starting at bitpos; the word after
  // the last is the 0xff EOF fill.
  __device__ __forceinline__ uint64_t peek(long long bitpos) const {
    long long bp = bitpos < max_bit ? bitpos : max_bit;
    int idx = (int)(bp >> 5);
    uint64_t lo = __ldg(words + idx);
    uint64_t hi = idx + 1 < nwords ? __ldg(words + idx + 1) : 0xFFFFFFFFull;
    return (lo | (hi << 32)) >> (bp & 31);
  }
};

// The register bit reader over a lane's row of W words (entropy.cu,
// wvc.cu): buf holds the nb (33..64 after win) next stream bits from
// position pos, zeros above them; nxt is the row's word widx, loaded ahead
// for the next refill. It yields the bits Stream::peek does for every bit
// of the row; past the row it reads the last word again, not the EOF fill,
// so its callers read through it only bits of the row and take a position
// near the row's end (where peek clamps) to peek or its window.
//
// One refill form serves both callers. The refill is selects and a load
// whose address is a counter, clamped to the row, with nothing waiting on
// it: the lanes of a warp refill at different words, so the register one
// refill loads is read by some lane's next refill soon after (about a word
// later in the correction scan), on the warp's path. Each refill also prefetches into L1 the row's line 16
// words ahead, so that load hits L1. Against a refill on a branch (loading
// the EOF fill past the row), in turns on an NVIDIA H100 80GB HBM3 at
// 700 W, this form made the lossless entropy kernel 3.53 -> 3.12 ms and
// its hybrid and wvc profiles ~3 % faster (kernel_ab.py; PERF.md).
struct BitBuf {
  const uint32_t* w;
  int W, pos, nb, widx;
  uint64_t buf;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t word(int i) const {
    return __ldg(w + min(i, W - 1));
  }
  __device__ __forceinline__ void start(const uint32_t* row, int words) {
    w = row;
    W = words;
    pos = 0;
    nb = 64;
    buf = (uint64_t)word(0) | ((uint64_t)word(1) << 32);
    widx = 2;
    nxt = word(2);
  }
  // >= 33 valid bits from pos
  __device__ __forceinline__ uint64_t win() {
    const bool need = nb < 33;
    buf |= (uint64_t)(need ? nxt : 0u) << (nb & 63);
    nb += need ? 32 : 0;
    widx += need;
    if (need) {
      nxt = word(widx);
      asm volatile("prefetch.global.L1 [%0];" ::"l"(w + min(widx + 16, W - 1)));
    }
    return buf;
  }
  __device__ __forceinline__ void skip(int k) {
    buf >>= k;
    nb -= k;
    pos += k;
  }
  // The count of leading stream ones, exact below 32 (a unary count is
  // only compared with LIMIT_ONES and LIMIT_ONES + 1).
  __device__ __forceinline__ int ones() {
    const uint32_t z = ~(uint32_t)win();
    return z ? __ffs(z) - 1 : 32;
  }
};

struct Code {
  long long code, consume;
};

// read_code (WordsUtils.cs:546-570) from a window: the minimal-binary code
// of a value in 0..maxcode and the bits it took. C# `1 << bitcount` is an
// int shift (mod-32), WordsUtils.cs:549.
__device__ __forceinline__ Code read_code(uint64_t win, long long maxcode) {
  long long bitcount = bit_length(maxcode);
  long long extras = wrap32(1LL << (bitcount & 31)) - maxcode - 1;
  Code r{bits_of(win, bitcount - 1), 0};
  if (bitcount > 0) {
    r.consume = bitcount - 1;
    if (r.code >= extras) {
      r.code = (r.code << 1) - extras + (long long)((win >> r.consume) & 1);
      r.consume += 1;
    }
  }
  return r;
}

}  // namespace wvpk
