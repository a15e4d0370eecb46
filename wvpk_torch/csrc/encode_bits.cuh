// The word coder's pieces shared by the two encode kernels
// (encode_words.cu, encode_hybrid.cu): a lane's bit writer into its
// payload row, the unary/gamma codes, the median intervals and their
// adaptation (WordsUtils.cs:272-511 run forward), the minimal-binary value
// code and the holding state that delays a word's unary count until the
// next word's first bit is known. The results are those of wvpk's XLA
// encoder (ops/encode_kernels.py), int64 where it is int64 there.
//
// The medians' type M is a template argument: int for lanes whose staged
// medians fit int32, long long for any other lane (each kernel checks its
// lane's medians once and runs one of the two bodies). With int32 medians
// every quantity of a word fits 32 bits:
// - av = |r| (r int32, ~r for r < 0) is in [0, 2^31 - 1];
// - g_i = (m_i >> 4) + 1 of an int32 median is in [-2^27 + 1, 2^27], so
//   g0 + g1 fits int32, and g2 = max(g_2, 1) is in [1, 2^27];
// - past the second median, num = av - g0 - g1 is in [0, 2^31 + 2^28)
//   (av >= g0 + g1 there, and g0 + g1 >= -2^28), a uint32, and so are its
//   quotient q by g2 and the ones count 2 + q; the flush count 2 oc + 1
//   that an escape codes can reach 2^33 and is formed in int64;
// - the word's interval is [low, low + width - 1] with width g0, g1 or g2
//   (>= 1: av < g0, av - g0 < g1 or g2 >= 1), so the code av - low and
//   the interval's maxcode width - 1 are in [0, 2^27) and low = av - code
//   is in (-2^27, 2^31);
// - the median updates are the 32-bit forms of stream.cuh, equal to the
//   int64 ones on every int32 median.
// The quotient of the usual words (0 to 3) comes from a compare ladder;
// only larger ones take a division, a 32-bit one in the int body.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "stream.cuh"

namespace wvpk {

constexpr int ENC_LIMIT_ONES = 16;

// (1 << n) - 1 for 0 <= n <= 63.
__device__ __forceinline__ uint64_t ones(long long n) {
  return (1ull << n) - 1;
}

// LSB-first bits into one lane's row of 32-bit payload words: a 64-bit
// accumulator holding fewer than 32 bits between calls, a word stored
// each time 32 bits are complete (none past the row's capacity; the bits
// are still counted).
struct Writer {
  uint32_t* row;
  int cap;              // words in the row
  int idx;              // next word to store
  int nacc;             // bits waiting in acc, < 32 between calls
  uint64_t acc;

  __device__ __forceinline__ Writer(uint32_t* r, int c)
      : row(r), cap(c), idx(0), nacc(0), acc(0) {}

  // n <= 32 bits of v (v < 2^n: with n = 0, v is 0)
  __device__ __forceinline__ void put(uint64_t v, int n) {
    acc |= v << nacc;
    nacc += n;
    if (nacc >= 32) {
      if (idx < cap) row[idx] = (uint32_t)acc;
      ++idx;
      acc >>= 32;
      nacc -= 32;
    }
  }

  // n <= 64 bits of v (v < 2^n), without a branch on n
  __device__ __forceinline__ void put_long(uint64_t v, int n) {
    put(v & 0xFFFFFFFFull, n < 32 ? n : 32);
    put(v >> 32, n > 32 ? n - 32 : 0);
  }

  // the last, partial word (its bits above the end are 0)
  __device__ __forceinline__ void finish() {
    if (nacc > 0 && idx < cap) row[idx] = (uint32_t)acc;
  }

  __device__ __forceinline__ long long total() const {
    return (long long)idx * 32 + nacc;
  }
};

// The Elias-style escape code of v >= 0 (WordsUtils.cs:321-335): unary(c)
// then the low c - 1 bits of v (top bit implicit); v < 2 is unary alone.
__device__ __forceinline__ void put_gamma(Writer& bw, long long v) {
  if (v < 2) {
    bw.put(ones(v), (int)v + 1);
    return;
  }
  int c = (int)bit_length(v);
  bw.put_long(ones(c), c + 1);
  bw.put_long((uint64_t)v & ones(c - 1), c - 1);
}

// A pending word's flush: unary(raw), or LIMIT_ONES ones and
// gamma(raw - LIMIT_ONES), then its pended payload.
__device__ __forceinline__ void put_flush(Writer& bw, long long raw,
                                          uint64_t pbits, int pnb) {
  if (raw >= ENC_LIMIT_ONES) {
    bw.put(ones(ENC_LIMIT_ONES), ENC_LIMIT_ONES + 1);
    put_gamma(bw, raw - ENC_LIMIT_ONES);
  } else {
    bw.put(ones(raw), (int)raw + 1);
  }
  bw.put_long(pbits, pnb);
}

// The type of a ones count, and of the quotient and the interval offset
// past the second median: uint32 with int32 medians (there 2 + q <=
// 2 + (2^31 - 1 + 2^28) < 2^32), int64 with int64 medians.
template <typename M>
using Count =
    std::conditional_t<std::is_same<M, int>::value, unsigned, long long>;

// A word's place among the medians: its ones count, its code av - low in
// the interval it selects and the interval's width.
template <typename M>
struct Interval {
  Count<M> oc;
  M code, width;
};

// The unsigned quotient of the int body, the signed one of the int64 body
// (num >= 0 wherever it is used).
__device__ __forceinline__ unsigned quotient(unsigned num, unsigned g2) {
  return num / g2;
}
__device__ __forceinline__ long long quotient(long long num, long long g2) {
  return num / g2;
}

// ones_count of |value| av against the pre-update medians m.
template <typename M>
__device__ __forceinline__ Interval<M> ones_count(M av, const M* m) {
  using N = Count<M>;
  const M g0 = (m[0] >> 4) + 1, g1 = (m[1] >> 4) + 1;
  const M g2 = max((m[2] >> 4) + 1, (M)1);
  const M g01 = g0 + g1;
  const N num = (N)av - (N)g01, w2 = (N)g2;
  N q = (N)(num >= w2) + (N)(num >= 2 * w2) + (N)(num >= 3 * w2);
  if (av >= g01 && num >= 4 * w2) q = quotient(num, w2);
  const bool c0 = av < g0, c1 = av < g01;
  return Interval<M>{c0 ? (N)0 : c1 ? (N)1 : 2 + q,
                     c0 ? av : c1 ? av - g0 : (M)(num - q * w2),
                     c0 ? g0 : c1 ? g1 : g2};
}

// The 5/7-2/7 median adaptation (WordsUtils.cs:433-475), every candidate
// computed and the ones count selecting.
template <typename M>
__device__ __forceinline__ void median_update(M* m, Count<M> oc) {
  const M d0 = med_dec<7>(m[0]), i0 = med_inc<7>(m[0]);
  const M d1 = med_dec<6>(m[1]), i1 = med_inc<6>(m[1]);
  const M d2 = med_dec<5>(m[2]), i2 = med_inc<5>(m[2]);
  m[0] = oc == 0 ? d0 : i0;
  m[1] = oc == 0 ? m[1] : oc == 1 ? d1 : i1;
  m[2] = oc < 2 ? m[2] : oc == 2 ? d2 : i2;
}

__device__ __forceinline__ int bits_needed(int x) {
  return x > 0 ? 32 - __clz(x) : 0;
}
__device__ __forceinline__ int bits_needed(long long x) {
  return (int)bit_length(x);
}

// read_code inverted: the minimal-binary code of `code` over [0, maxcode]
// (maxcode >= 0); returns its bits, its length in vl.
template <typename M>
__device__ __forceinline__ uint64_t value_code(M code, M maxcode, int& vl) {
  const int bc = bits_needed(maxcode);
  const M extras = ((M)1 << bc) - maxcode - 1;
  const bool small = code < extras;  // never with bc == 0: extras is 0
  const M cc = code + extras;
  vl = small ? bc - 1 : bc;
  return small ? (uint64_t)code
               : (uint64_t)(cc >> 1) |
                     ((uint64_t)(cc & 1) << (bc > 0 ? bc - 1 : 0));
}

// The holding state: a word coded from the clear state, or one that ends
// with holding_one, waits for the next word's first bit. The clear state
// is `!valid` (a word that resolves holding_zero clears it). C is the
// ones count's type (Count<M>).
template <typename C>
struct Pending {
  bool valid = false;
  C oc = 0;           // the pended word's ones count as its flush writes it
  uint64_t bits = 0;
  int nb = 0;

  // A coded word with ones count woc and payload (wbits, wnb), and `gate`
  // zero bits (the hybrid run gate's gamma(0), only in the clear state)
  // ahead of it: flushes the pending word (holding_zero when woc is 0,
  // else holding_one), then writes the payload at once (holding_zero) or
  // pends it. The flush's unary code and pended payload go out in one
  // write, and the transitions are selects; only a LIMIT_ONES escape
  // branches. The flush's count raw = 2 oc + (woc != 0) reaches
  // LIMIT_ONES exactly when oc >= LIMIT_ONES / 2, so raw itself (up to
  // 2^33) is formed only in the escape.
  __device__ __forceinline__ void code(Writer& bw, C woc, uint64_t wbits,
                                       int wnb, int gate = 0) {
    const bool z = woc == 0;
    const bool esc = valid && oc >= (C)(ENC_LIMIT_ONES / 2);
    if (esc) {
      bw.put(ones(ENC_LIMIT_ONES), ENC_LIMIT_ONES + 1);
      put_gamma(bw, 2 * (long long)oc + (z ? 0 : 1) - ENC_LIMIT_ONES);
    }
    // unary(raw) is u = raw + 1 bits: raw ones and a zero
    const int u = valid && !esc ? 2 * (int)oc + (z ? 1 : 2) : 0;
    bw.put_long(valid ? ones(u > 0 ? u - 1 : 0) | (bits << u) : 0,
                valid ? u + nb : gate);
    const bool now = valid && z;
    bw.put_long(now ? wbits : 0, now ? wnb : 0);
    oc = valid ? woc - 1 : woc;
    bits = wbits;
    nb = wnb;
    valid = !now;
  }

  // the final flush (EntropyEncoder.finish: b = 0)
  __device__ __forceinline__ void finish(Writer& bw) {
    if (valid) put_flush(bw, 2 * (long long)oc, bits, nb);
  }
};

}  // namespace wvpk
