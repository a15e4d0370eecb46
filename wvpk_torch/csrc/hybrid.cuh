// The hybrid profile's arithmetic, shared by the entropy decode kernel
// (entropy.cu) and the hybrid encode kernel (encode_hybrid.cu): the
// format's fixed-point log2/exp2 over the 256-entry tables, the slow-level
// decay and update_error_limit (WordsUtils.cs:195-261), int64-exact as
// wvpk's XLA versions are.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace wvpk {

constexpr int SLS = 8;
constexpr long long SLO = 1LL << (SLS - 1);
constexpr int TABLE = 256;  // entries of each of the log2 and exp2 tables

// mylog2 (WordsUtils.cs:588-608); the left shift runs unsigned, so a
// negative value (a corrupt stream's) is defined as in the plain version.
__device__ __forceinline__ long long mylog2(long long av, const int* log2t) {
  av += av >> 9;
  long long dbits = bit_length(av);
  long long sh = dbits - 9;
  long long v = sh >= 0 ? av >> sh : shl(av, -sh);
  return (dbits << 8) + log2t[v & 0xFF];
}

// exp2s (WordsUtils.cs:633-646) in int64, with the int32 wrap of its left
// shift: the shift runs on a uint64_t, where an overflowing shift is
// defined.
__device__ __forceinline__ long long exp2s(long long log, const int* exp2t) {
  long long a = log < 0 ? -log : log;
  long long v = exp2t[a & 0xFF] | 0x100;
  long long sh = a >> 8;
  long long r = sh <= 9 ? v >> (9 - sh)
                        : wrap32(shl(v, sh - 9 < 63 ? sh - 9 : 63));
  return log < 0 ? -r : r;
}

__device__ __forceinline__ long long slow_decay(long long slow) {
  return slow - ((slow + SLO) >> SLS);
}

// update_error_limit, before a channel-A word: the bitrate accumulators
// acc[c] advance by delta[c] and the error limits err[c] follow them (and,
// with HYBRID_BITRATE, the slow levels). Mono touches channel 0 only.
template <bool MONO, bool BITRATE, bool BALANCE>
__device__ __forceinline__ void update_error_limit(const long long* slow,
                                                   long long* acc,
                                                   const long long* delta,
                                                   long long* err,
                                                   const int* exp2t) {
  constexpr int C = MONO ? 1 : 2;
  long long br[2];
  for (int c = 0; c < C; ++c) {
    acc[c] = (long long)((uint64_t)acc[c] + (uint64_t)delta[c]);
    br[c] = wrap32(acc[c] >> 16);
  }
  if (!BITRATE) {
    for (int c = 0; c < C; ++c) err[c] = exp2s(br[c], exp2t);
    return;
  }
  long long slow_log[2];
  for (int c = 0; c < C; ++c) slow_log[c] = (slow[c] + SLO) >> SLS;
  if (BALANCE && !MONO) {
    long long balance = (slow_log[1] - slow_log[0] + br[1] + 1) >> 1;
    long long b0, b1;
    if (balance > br[0]) {
      b0 = 0;
      b1 = br[0] * 2;
    } else if (-balance > br[0]) {
      b0 = br[0] * 2;
      b1 = 0;
    } else {
      b0 = br[0] - balance;
      b1 = br[0] + balance;
    }
    br[0] = b0;
    br[1] = b1;
  }
  for (int c = 0; c < C; ++c) {
    long long d = slow_log[c] - br[c];
    err[c] = d > -0x100 ? exp2s(d + 0x100, exp2t) : 0;
  }
}

}  // namespace wvpk
