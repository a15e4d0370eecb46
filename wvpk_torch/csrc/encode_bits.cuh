// The word coder's pieces shared by the two encode kernels
// (encode_words.cu, encode_hybrid.cu): a lane's bit writer into its
// payload row, the unary/gamma codes, the median intervals and their
// adaptation (WordsUtils.cs:272-511 run forward), the minimal-binary value
// code and the holding state that delays a word's unary count until the
// next word's first bit is known. The arithmetic is wvpk's XLA encoder's
// (ops/encode_kernels.py), int64 where it is int64 there.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace wvpk {

constexpr int ENC_LIMIT_ONES = 16;
constexpr long long ENC_DIV0 = 128, ENC_DIV1 = 64, ENC_DIV2 = 32;

// (1 << n) - 1 for 0 <= n <= 63.
__device__ __forceinline__ uint64_t ones(long long n) {
  return (1ull << n) - 1;
}

// LSB-first bits into one lane's row of 32-bit payload words: a 64-bit
// accumulator, a word stored each time 32 bits are complete.
struct Writer {
  uint32_t* row;
  int cap;              // words in the row
  int idx;              // next word to store
  int nacc;             // bits waiting in acc, < 32 between calls
  uint64_t acc;
  long long total;      // bits written

  __device__ __forceinline__ Writer(uint32_t* r, int c)
      : row(r), cap(c), idx(0), nacc(0), acc(0), total(0) {}

  // n <= 32 bits of v (v < 2^n)
  __device__ __forceinline__ void put(uint64_t v, int n) {
    acc |= v << nacc;
    nacc += n;
    total += n;
    if (nacc >= 32) {
      if (idx < cap) row[idx] = (uint32_t)acc;
      ++idx;
      acc >>= 32;
      nacc -= 32;
    }
  }

  // n <= 64 bits of v
  __device__ __forceinline__ void put_long(uint64_t v, int n) {
    if (n > 32) {
      put(v & 0xFFFFFFFFull, 32);
      put(v >> 32, n - 32);
    } else {
      put(v, n);
    }
  }

  // the last, partial word (its bits above the end are 0)
  __device__ __forceinline__ void finish() {
    if (nacc > 0 && idx < cap) row[idx] = (uint32_t)acc;
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

// ones_count of |value| av against the pre-update medians m, and the
// interval [low, high] it selects.
__device__ __forceinline__ long long ones_count(long long av,
                                                const long long* m,
                                                long long& low,
                                                long long& high) {
  long long g0 = (m[0] >> 4) + 1, g1 = (m[1] >> 4) + 1;
  long long g2 = max((m[2] >> 4) + 1, 1LL);
  if (av < g0) {
    low = 0;
    high = g0 - 1;
    return 0;
  }
  if (av < g0 + g1) {
    low = g0;
    high = g0 + g1 - 1;
    return 1;
  }
  long long oc = 2 + (av - g0 - g1) / g2;
  low = g0 + g1 + (oc - 2) * g2;
  high = low + g2 - 1;
  return oc;
}

// The 5/7-2/7 median adaptation (WordsUtils.cs:433-475).
__device__ __forceinline__ void median_update(long long* m, long long oc) {
  if (oc == 0) {
    m[0] = wrap32(m[0] - ((m[0] + (ENC_DIV0 - 2)) >> 7) * 2);
    return;
  }
  m[0] = wrap32(m[0] + ((m[0] + ENC_DIV0) >> 7) * 5);
  if (oc == 1) {
    m[1] = wrap32(m[1] - ((m[1] + (ENC_DIV1 - 2)) >> 6) * 2);
    return;
  }
  m[1] = wrap32(m[1] + ((m[1] + ENC_DIV1) >> 6) * 5);
  if (oc == 2)
    m[2] = wrap32(m[2] - ((m[2] + (ENC_DIV2 - 2)) >> 5) * 2);
  else
    m[2] = wrap32(m[2] + ((m[2] + ENC_DIV2) >> 5) * 5);
}

// read_code inverted: the minimal-binary code of av - low over
// [0, high - low]; returns its bits, its length in vl.
__device__ __forceinline__ uint64_t value_code(long long av, long long low,
                                               long long high, int& vl) {
  long long code = av - low, maxcode = high - low;
  int bitcount = (int)bit_length(maxcode);
  long long extras = (1LL << bitcount) - maxcode - 1;
  if (bitcount == 0) {
    vl = 0;
    return (uint64_t)code;
  }
  if (code < extras) {
    vl = bitcount - 1;
    return (uint64_t)code;
  }
  long long cc = code + extras;
  vl = bitcount;
  return (uint64_t)(cc >> 1) | ((uint64_t)(cc & 1) << (bitcount - 1));
}

// The holding state: a word coded from the clear state, or one that ends
// with holding_one, waits for the next word's first bit.
struct Pending {
  bool clear = true, valid = false;
  long long oc = 0;
  uint64_t bits = 0;
  int nb = 0;

  // A coded word with ones count woc and payload (wbits, wnb): flushes
  // the pending word where the holding resolves, then writes the payload
  // at once (holding_zero) or pends it.
  __device__ __forceinline__ void code(Writer& bw, long long woc,
                                       uint64_t wbits, int wnb) {
    bool h0 = !clear && woc == 0, h1 = !clear && woc != 0;
    if ((h0 || h1) && valid)
      put_flush(bw, 2 * oc + (h1 ? 1 : 0), bits, nb);
    if (h0) {
      bw.put_long(wbits, wnb);
      clear = true;
      valid = false;
      return;
    }
    // from the clear state, or holding_one: this word pends
    valid = true;
    oc = woc - (h1 ? 1 : 0);
    bits = wbits;
    nb = wnb;
    clear = false;
  }

  // the final flush (EntropyEncoder.finish: b = 0)
  __device__ __forceinline__ void finish(Writer& bw) {
    if (valid) put_flush(bw, 2 * oc, bits, nb);
  }
};

}  // namespace wvpk
