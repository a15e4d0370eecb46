// Lossless WavPack entropy decode for Hopper (sm_90a): one thread per lane.
//
// Replaces wvpk/ops/entropy_pallas.py::_entropy_kernel (lossless profile).
// The semantics are those of wvpk/ops/entropy.py::entropy_decode and of its
// port wvpk_torch/ops/entropy.py (the plain version): int64-exact medians,
// not the Pallas kernel's 32-bit median wrap. It mirrors the reference's
// get_words (WordsUtils.cs:272-511): zero runs, unary ones_count with the
// holding_one/holding_zero carry, the LIMIT_ONES escape, median intervals,
// read_code and the sign bit.
//
// What bounds it: every word's position in a lane's bitstream depends on
// the length of the word before, so a lane is one serial scan and the only
// parallelism is the lane count. A bucket of the bench corpus has ~8,400
// lanes: ~8,400 threads, about two warps per SM on 132 SMs where an SM can
// hold 64. The kernel is therefore bound by the latency of each thread's
// dependent loads and branches, not by memory bandwidth (it reads each
// payload byte once and writes 4 bytes per sample and channel).
//
// Design: each thread reads its lane's contiguous words through a 64-bit
// window (two 32-bit loads, served from L1 for consecutive reads) and takes
// real branches for zero runs, escapes and gammas: they are rare, and the
// lanes of a warp mostly take the same path. Warps are one per block so
// the ~260 blocks spread over all SMs. Residuals are written in the
// (T, L, C) layout, so a warp's stores at one sample index are contiguous.
// The Pallas kernel's VMEM group cache, speculative any-reduce and split
// 32-bit limbs have no counterpart here: the card has native 64-bit
// integers, per-thread control flow and caches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LIMIT_ONES = 16;
constexpr long long DIV0 = 128, DIV1 = 64, DIV2 = 32;
constexpr int THREADS = 32;

__device__ __forceinline__ long long wrap32(long long x) {
  return (long long)(int32_t)(uint32_t)(uint64_t)x;
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

struct Stream {
  const uint32_t* words;  // this lane's row of the (L, W) array
  int nwords;
  long long max_bit;      // positions past the last word clamp to its start

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
  bool h1, h0, done;
  int ndec;
};

// One get_words iteration for channel C of an active lane; returns the
// residual (0 for a zero-run word or an EOF break).
template <int C>
__device__ __forceinline__ int decode_word(Lane& s, const Stream& st) {
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

  // ---- value: read_code (WordsUtils.cs:546-570) and the sign bit ----
  uint64_t win = st.peek(s.bitpos);
  long long maxcode = width - 1;
  long long bitcount = maxcode > 0 ? 64 - __clzll(maxcode) : 0;
  // C# `1 << bitcount` is an int shift (mod-32), WordsUtils.cs:549
  long long extras = wrap32(1LL << (bitcount & 31)) - maxcode - 1;
  long long code = bits_of(win, bitcount - 1);
  long long consume = 0;
  if (bitcount > 0) {
    consume = bitcount - 1;
    if (code >= extras) {
      code = (code << 1) - extras + (long long)((win >> consume) & 1);
      consume += 1;
    }
  }
  long long mid = low + code;
  bool sign = (win >> (consume < 62 ? consume : 62)) & 1;
  s.bitpos += consume + 1;
  s.ndec += 1;
  return (int)wrap32(sign ? ~mid : mid);
}

template <bool MONO>
__global__ void __launch_bounds__(THREADS)
entropy_kernel(const uint32_t* __restrict__ words,
               const long long* __restrict__ med0,
               const int* __restrict__ nwords_lane, int* __restrict__ res,
               int* __restrict__ broke, int* __restrict__ ndec, int L, int W,
               int T) {
  constexpr int C = MONO ? 1 : 2;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  Stream st{words + (size_t)lane * W, W, (long long)(W - 1) * 32};
  Lane s;
  s.bitpos = 0;
  s.zacc = 0;
  s.h1 = s.h0 = s.done = false;
  s.ndec = 0;
  for (int c = 0; c < 2; ++c)
    for (int i = 0; i < 3; ++i) s.med[c][i] = med0[lane * 6 + c * 3 + i];
  int ns = nwords_lane[lane] / C;
  int* out = res + (size_t)lane * C;
  const size_t row = (size_t)L * C;
  for (int t = 0; t < T; ++t, out += row) {
    int a = 0, b = 0;
    if (t < ns && !s.done) {
      a = decode_word<0>(s, st);
      if (!MONO && !s.done) b = decode_word<1>(s, st);
    }
    out[0] = a;
    if (!MONO) out[1] = b;
  }
  broke[lane] = s.done ? 1 : 0;
  ndec[lane] = s.ndec;
}

}  // namespace

extern "C" int wvpk_entropy_decode(const void* words, const void* med0,
                                   const void* nwords_lane, void* res,
                                   void* broke, void* ndec, int L, int W,
                                   int T, int mono, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  auto w = (const uint32_t*)words;
  auto m = (const long long*)med0;
  auto n = (const int*)nwords_lane;
  if (mono)
    entropy_kernel<true><<<grid, block, 0, s>>>(
        w, m, n, (int*)res, (int*)broke, (int*)ndec, L, W, T);
  else
    entropy_kernel<false><<<grid, block, 0, s>>>(
        w, m, n, (int*)res, (int*)broke, (int*)ndec, L, W, T);
  return (int)cudaGetLastError();
}
