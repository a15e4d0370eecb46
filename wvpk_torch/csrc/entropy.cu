// WavPack entropy decode for Hopper (sm_90a): one thread per lane, the
// lossless and hybrid profiles, with the hybrid-lossless (wvc) outputs.
//
// Replaces wvpk/ops/entropy_pallas.py::_entropy_kernel. The semantics are
// those of wvpk/ops/entropy.py::entropy_decode and of its port
// wvpk_torch/ops/entropy.py (the plain version): int64-exact medians, error
// limits and bitrate accumulators, not the Pallas kernel's 32-bit median
// wrap and split limbs. It mirrors the reference's get_words
// (WordsUtils.cs:272-511): zero runs, unary ones_count with the
// holding_one/holding_zero carry, the LIMIT_ONES escape, median intervals,
// read_code and the sign bit. The hybrid profile adds update_error_limit
// (WordsUtils.cs:195-261) before each channel-A word, the error-limited
// binary search for the value and, with HYBRID_BITRATE, the slow_level
// recurrence through mylog2/exp2s; with WVC each word also reports the
// interval the search narrowed (maxcode = hi - lo, base = lo - mid), which
// is all the correction scan (csrc/wvc.cu) needs.
//
// What bounds it: every word's position in a lane's bitstream depends on
// the length of the word before, so a lane is one serial scan and the only
// parallelism is the lane count. A bucket of the bench corpus has ~8,400
// lanes: ~8,400 threads, about two warps per SM on 132 SMs where an SM can
// hold 64. The kernel is therefore bound by the latency of each thread's
// dependent loads and branches, not by memory bandwidth (it reads each
// payload byte once and writes 4 bytes per sample and channel, 12 with
// WVC).
//
// Design: each thread reads its lane's contiguous words through a 64-bit
// window (two 32-bit loads, served from L1 for consecutive reads) and takes
// real branches for zero runs, escapes and gammas: they are rare, and the
// lanes of a warp mostly take the same path. The hybrid search is a short
// data-dependent loop (it stops when hi - lo reaches the error limit, at
// most 32 steps), not the Pallas kernel's 32 unrolled selects; all of its
// bits come from the one window already loaded for the value. The hybrid
// state (slow levels, 64-bit bitrate accumulators, error limits, deltas)
// lives in registers; the log2/exp2 tables sit in shared memory. The
// profile is a template, so the lossless kernel carries none of it. Warps
// are one per block so the ~260 blocks spread over all SMs. Outputs are
// written in the (T, L, C) layout, so a warp's stores at one sample index
// are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "hybrid.cuh"
#include "stream.cuh"

namespace {

using namespace wvpk;

constexpr int LIMIT_ONES = 16;
constexpr long long DIV0 = 128, DIV1 = 64, DIV2 = 32;
constexpr int THREADS = 32;

struct Gamma {
  long long value, consume;
  bool broke;
};

// WavPack's Elias-gamma read: zero-run lengths and LIMIT_ONES escapes.
__device__ __forceinline__ Gamma read_gamma(const Stream& s, long long pos) {
  long long cbits = trailing_ones(s.peek(pos));
  if (cbits > 33) cbits = 33;
  Gamma g;
  g.broke = cbits >= 33;
  if (cbits < 2) {
    g.value = cbits;
    g.consume = cbits + 1;
  } else {
    long long data = bits_of(s.peek(pos + cbits + 1), cbits - 1);
    g.value = data | (1LL << (cbits - 1 < 62 ? cbits - 1 : 62));
    g.consume = 2 * cbits;
  }
  return g;
}

struct Lane {
  long long bitpos, zacc;
  long long med[2][3];
  // hybrid state, read only by the hybrid profile
  long long slow[2], acc[2], delta[2], err[2];
  bool h1, h0, done;
  int ndec;
};

struct Tables {
  const int* log2t;
  const int* exp2t;
};

// One get_words iteration for channel C of an active lane; returns the
// residual (0 for a zero-run word or an EOF break) and, for WVC, the
// narrowed interval (0 where the word carries no correction code).
template <int C, bool MONO, bool HYBRID, bool BITRATE, bool BALANCE,
          bool WVC>
__device__ __forceinline__ int decode_word(Lane& s, const Stream& st,
                                           const Tables& tb, int& mc,
                                           int& base) {
  // ---- zero-run branch (WordsUtils.cs:304-352) ----
  if ((s.med[0][0] & ~1LL) == 0 && (s.med[1][0] & ~1LL) == 0 && !s.h1 &&
      !s.h0) {
    bool emit_zero = false;
    if (s.zacc > 0) {
      s.zacc -= 1;
      emit_zero = s.zacc > 0;
    } else {
      Gamma g = read_gamma(st, s.bitpos);
      if (g.broke) {
        s.done = true;
        return 0;
      }
      s.bitpos += g.consume;
      if (g.value > 0) {
        s.zacc = g.value;
        for (int c = 0; c < 2; ++c)
          for (int i = 0; i < 3; ++i) s.med[c][i] = 0;
        emit_zero = true;
      }
    }
    if (emit_zero) {
      if (BITRATE) s.slow[C] = slow_decay(s.slow[C]);
      s.ndec += 1;
      return 0;
    }
  }

  // ---- unary ones_count with holding carry (WordsUtils.cs:354-428) ----
  long long oc;
  if (s.h0) {
    oc = 0;
    s.h0 = false;
    s.h1 = false;
  } else {
    long long t_u = trailing_ones(st.peek(s.bitpos));
    long long raw, consume;
    if (t_u >= LIMIT_ONES + 1) {
      s.done = true;
      return 0;
    }
    if (t_u == LIMIT_ONES) {
      Gamma g = read_gamma(st, s.bitpos + 17);
      if (g.broke) {
        s.done = true;
        return 0;
      }
      raw = g.value + LIMIT_ONES;
      consume = 17 + g.consume;
    } else {
      raw = t_u;
      consume = t_u + 1;
    }
    s.bitpos += consume;
    oc = (raw >> 1) + (s.h1 ? 1 : 0);
    s.h1 = (raw & 1) != 0;
    s.h0 = !s.h1;
  }

  // ---- hybrid error limit (WordsUtils.cs:430-431) ----
  if (HYBRID && C == 0)
    update_error_limit<MONO, BITRATE, BALANCE>(s.slow, s.acc, s.delta, s.err,
                                               tb.exp2t);

  // ---- median interval (WordsUtils.cs:433-475) ----
  long long* m = s.med[C];
  long long g0 = (m[0] >> 4) + 1, g1 = (m[1] >> 4) + 1, g2 = (m[2] >> 4) + 1;
  long long low, width;
  if (oc == 0) {
    low = 0;
    width = g0;
    m[0] = wrap32(m[0] - ((m[0] + (DIV0 - 2)) >> 7) * 2);
  } else {
    m[0] = wrap32(m[0] + ((m[0] + DIV0) >> 7) * 5);
    if (oc == 1) {
      low = g0;
      width = g1;
      m[1] = wrap32(m[1] - ((m[1] + (DIV1 - 2)) >> 6) * 2);
    } else {
      m[1] = wrap32(m[1] + ((m[1] + DIV1) >> 6) * 5);
      width = g2;
      if (oc == 2) {
        low = g0 + g1;
        m[2] = wrap32(m[2] - ((m[2] + (DIV2 - 2)) >> 5) * 2);
      } else {
        low = g0 + g1 + (oc - 2) * g2;
        m[2] = wrap32(m[2] + ((m[2] + DIV2) >> 5) * 5);
      }
    }
  }

  // ---- value: read_code (WordsUtils.cs:546-570), or the hybrid search
  // where the error limit is not 0, and the sign bit ----
  uint64_t win = st.peek(s.bitpos);
  long long mid, consume = 0;
  if (HYBRID && s.err[C] != 0) {
    // at most 32 steps, one stream bit each; the window holds 33 bits,
    // the last for the sign
    const long long err = s.err[C];
    long long lo = low, hi = low + width - 1;
    mid = (hi + lo + 1) >> 1;
    while (consume < 32 && hi - lo > err) {
      if ((win >> consume) & 1)
        lo = mid;
      else
        hi = mid - 1;
      mid = (hi + lo + 1) >> 1;
      ++consume;
    }
    if (WVC) {
      mc = (int)(hi - lo);
      base = (int)(lo - mid);
    }
  } else {
    Code rc = read_code(win, width - 1);
    mid = low + rc.code;
    consume = rc.consume;
  }
  bool sign = (win >> (consume < 62 ? consume : 62)) & 1;
  s.bitpos += consume + 1;
  s.ndec += 1;
  if (BITRATE) s.slow[C] = slow_decay(s.slow[C]) + mylog2(mid, tb.log2t);
  return (int)wrap32(sign ? ~mid : mid);
}

template <bool MONO, bool HYBRID, bool BITRATE, bool BALANCE, bool WVC>
__global__ void __launch_bounds__(THREADS)
entropy_kernel(const uint32_t* __restrict__ words,
               const long long* __restrict__ med0,
               const long long* __restrict__ slow0,
               const long long* __restrict__ acc0,
               const long long* __restrict__ delta0,
               const int* __restrict__ tables,
               const int* __restrict__ nwords_lane, int* __restrict__ res,
               int* __restrict__ mc_out, int* __restrict__ base_out,
               int* __restrict__ broke, int* __restrict__ ndec, int L, int W,
               int T) {
  constexpr int C = MONO ? 1 : 2;
  __shared__ int tab[2 * TABLE];
  if (HYBRID) {
    for (int i = threadIdx.x; i < 2 * TABLE; i += blockDim.x)
      tab[i] = tables[i];
    __syncthreads();
  }
  const Tables tb{tab, tab + TABLE};
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  Stream st(words + (size_t)lane * W, W);
  Lane s;
  s.bitpos = 0;
  s.zacc = 0;
  s.h1 = s.h0 = s.done = false;
  s.ndec = 0;
  for (int c = 0; c < 2; ++c) {
    for (int i = 0; i < 3; ++i) s.med[c][i] = med0[lane * 6 + c * 3 + i];
    s.slow[c] = HYBRID ? slow0[lane * 2 + c] : 0;
    s.acc[c] = HYBRID ? acc0[lane * 2 + c] : 0;
    s.delta[c] = HYBRID ? delta0[lane * 2 + c] : 0;
    s.err[c] = 0;
  }
  int ns = nwords_lane[lane] / C;
  const size_t row = (size_t)L * C;
  size_t off = (size_t)lane * C;
  for (int t = 0; t < T; ++t, off += row) {
    int a = 0, b = 0, mca = 0, mcb = 0, ba = 0, bb = 0;
    if (t < ns && !s.done) {
      a = decode_word<0, MONO, HYBRID, BITRATE, BALANCE, WVC>(s, st, tb, mca,
                                                              ba);
      if (!MONO && !s.done)
        b = decode_word<1, MONO, HYBRID, BITRATE, BALANCE, WVC>(s, st, tb,
                                                                mcb, bb);
    }
    res[off] = a;
    if (!MONO) res[off + 1] = b;
    if (WVC) {
      mc_out[off] = mca;
      base_out[off] = ba;
      if (!MONO) {
        mc_out[off + 1] = mcb;
        base_out[off + 1] = bb;
      }
    }
  }
  broke[lane] = s.done ? 1 : 0;
  ndec[lane] = s.ndec;
}

struct Args {
  const uint32_t* words;
  const long long *med0, *slow0, *acc0, *delta0;
  const int *tables, *nwords_lane;
  int *res, *mc, *base, *broke, *ndec;
  int L, W, T;
};

template <bool MONO, bool HYBRID, bool BITRATE, bool BALANCE, bool WVC>
void launch(const Args& a, cudaStream_t s) {
  dim3 grid((a.L + THREADS - 1) / THREADS), block(THREADS);
  entropy_kernel<MONO, HYBRID, BITRATE, BALANCE, WVC><<<grid, block, 0, s>>>(
      a.words, a.med0, a.slow0, a.acc0, a.delta0, a.tables, a.nwords_lane,
      a.res, a.mc, a.base, a.broke, a.ndec, a.L, a.W, a.T);
}

template <bool MONO, bool HYBRID, bool BITRATE, bool BALANCE>
void launch_wvc(const Args& a, bool wvc, cudaStream_t s) {
  if (wvc)
    launch<MONO, HYBRID, BITRATE, BALANCE, true>(a, s);
  else
    launch<MONO, HYBRID, BITRATE, BALANCE, false>(a, s);
}

template <bool MONO>
void launch_profile(const Args& a, bool hybrid, bool bitrate, bool balance,
                    bool wvc, cudaStream_t s) {
  if (!hybrid)
    launch<MONO, false, false, false, false>(a, s);
  else if (!bitrate)
    launch_wvc<MONO, true, false, false>(a, wvc, s);
  else if (!balance || MONO)  // balance acts on true stereo only
    launch_wvc<MONO, true, true, false>(a, wvc, s);
  else
    launch_wvc<MONO, true, true, true>(a, wvc, s);
}

}  // namespace

// words (L, W) u32; med0 (L, 2, 3), slow0/acc0/delta0 (L, 2) int64;
// tables: log2 then exp2, 256 int32 each; res, and for wvc mc and base,
// (T, L, C) int32; broke, ndec (L,) int32. The hybrid arguments are read
// only when `hybrid` is set, mc/base only when `wvc` is (which needs
// `hybrid`). Returns the launch's CUDA error code.
extern "C" int wvpk_entropy_decode(const void* words, const void* med0,
                                   const void* slow0, const void* acc0,
                                   const void* delta0, const void* tables,
                                   const void* nwords_lane, void* res,
                                   void* mc, void* base, void* broke,
                                   void* ndec, int L, int W, int T, int mono,
                                   int hybrid, int bitrate, int balance,
                                   int wvc, void* stream) {
  if (wvc && !hybrid) return (int)cudaErrorInvalidValue;
  Args a{(const uint32_t*)words, (const long long*)med0,
         (const long long*)slow0, (const long long*)acc0,
         (const long long*)delta0, (const int*)tables,
         (const int*)nwords_lane, (int*)res, (int*)mc, (int*)base,
         (int*)broke, (int*)ndec, L, W, T};
  cudaStream_t s = (cudaStream_t)stream;
  if (mono)
    launch_profile<true>(a, hybrid, bitrate, balance, wvc, s);
  else
    launch_profile<false>(a, hybrid, bitrate, balance, wvc, s);
  return (int)cudaGetLastError();
}
