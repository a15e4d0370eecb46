// Bit-level helpers shared by the kernels that read a lane's staged
// bitstream (entropy.cu, wvc.cu, wvx.cu) and by the encode word coders
// (encode_bits.cuh): C#'s int32 wrap, shifts with defined overflow, a
// 64-bit window over the lane's 32-bit words, and the median updates.

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
