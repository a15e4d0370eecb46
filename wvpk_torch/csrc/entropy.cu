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
// parallelism is the lane count. A bucket of the bench corpus has ~8,300
// lanes: about two warps per SM on 132 SMs, where an SM can hold 64. A
// launch therefore takes as long as one lane's chain of dependent
// operations, ~8,200 words of a 16-bit stereo block, and not the bytes it
// moves (each payload byte read once, 4 bytes written per sample and
// channel, 12 with WVC: ~0.1 ms of the card's bandwidth).
//
// Design: the chain of a word is kept short.
// - A register bit reader (BitBuf, stream.cuh): each thread holds its
//   lane's next 33 to 64 stream bits in a 64-bit register, with the count
//   of valid bits. A word's unary count (__ffsll of the inverted buffer),
//   its code (read_code or the hybrid search) and its sign bit read that
//   register; when fewer than 33 bits remain, one 32-bit word shifts in.
//   That word was loaded one refill earlier at an address that is a
//   counter, not a function of the bits just decoded, so its latency
//   leaves the chain: a 16-bit word of ~11 bits costs a load every ~3
//   words, where a window read at each bit position cost two dependent
//   loads 2-4 times a word. The refill is stream.cuh's one form, shared
//   with the correction scan (selects, a load clamped to the row and an
//   L1 prefetch 16 words ahead); the reader holds only bits of the row.
//   Zero runs and LIMIT_ONES escapes read their Elias-gamma codes through
//   the same register.
// - The tail of a row: Stream::peek clamps a position past the start of
//   the row's last word to that start and reads the EOF fill after it,
//   which decides `broke` and `ndec` on truncated and corrupt streams. A
//   step that starts within TAIL_BITS of the last word's start (every read
//   of a step lies within 356 bits of its start) and every lane whose
//   medians do not fit int32 run the peek-based path, which is the
//   int64 decoder of earlier versions unchanged; before that point both
//   paths read the same bits.
// - 32-bit arithmetic where the value provably fits: the bit position
//   (the wrapper checks W * 32 < 2^31), unary counts, code widths and the
//   medians (med_inc / med_dec in stream.cuh state why the 32-bit update
//   equals the int64 one on every int32 median); the interval base and
//   the value stay int64, as an escape's ones count can reach 2^32.
// - Real branches for zero runs, escapes and gammas: they are rare, and
//   the lanes of a warp mostly take the same path. The hybrid search is a
//   short data-dependent loop (it stops when hi - lo reaches the error
//   limit, at most 32 steps), not the Pallas kernel's 32 unrolled selects.
//   The hybrid state (slow levels, 64-bit bitrate accumulators, error
//   limits, deltas) lives in registers; the log2/exp2 tables sit in shared
//   memory. The profile is a template, so the lossless kernel carries none
//   of it. Warps are one per block so the ~260 blocks spread over all SMs.
//   Outputs are written in the (T, L, C) layout, so a warp's stores at one
//   sample index are contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "hybrid.cuh"
#include "stream.cuh"

namespace {

using namespace wvpk;

constexpr int LIMIT_ONES = 16;
constexpr int THREADS = 32;
// A step (two words) reads at most 2 x 178 bits past its start: a
// zero-run gamma (64), a LIMIT_ONES escape (17 + 64) and a value with its
// sign (33) per word. Steps that start closer than this to the last
// word's start take the peek path.
constexpr int TAIL_BITS = 384;

// Stream::peek at a position, the reader of the row's tail.
struct PeekReader {
  const Stream& st;
  long long pos;

  __device__ __forceinline__ uint64_t win() const { return st.peek(pos); }
  __device__ __forceinline__ void skip(int k) { pos += k; }
  __device__ __forceinline__ int ones() const {
    return (int)trailing_ones(win());
  }
};

struct Gamma {
  long long value;
  bool broke;
};

// WavPack's Elias-gamma read (zero-run lengths and LIMIT_ONES escapes):
// the ones count (at most 32 of them, 33 is the EOF break), the zero after
// it, then count - 1 bits of value.
template <class R>
__device__ __forceinline__ Gamma read_gamma(R& rd) {
  long long cbits = trailing_ones(rd.win());
  if (cbits > 33) cbits = 33;
  Gamma g;
  g.broke = cbits >= 33;
  if (g.broke) return g;
  rd.skip((int)cbits + 1);
  if (cbits < 2) {
    g.value = cbits;
  } else {
    g.value = bits_of(rd.win(), cbits - 1) | (1LL << (cbits - 1));
    rd.skip((int)cbits - 1);
  }
  return g;
}

// read_code for an int32 maxcode: maxcode = (m >> 4) of an int32 median
// is below 2^27, so the code and its width fit int32 (read_code in
// stream.cuh is the int64 form).
__device__ __forceinline__ Code read_code(uint64_t win, int maxcode) {
  const uint32_t lo = (uint32_t)win;
  const int bitcount = maxcode > 0 ? 32 - __clz(maxcode) : 0;
  const int n = bitcount - 1;  // the code's low bits; -1 for no code
  const int extras = (int)(1u << bitcount) - maxcode - 1;
  const int code = n > 0 ? (int)(lo & ((1u << n) - 1)) : 0;
  const bool extra = n >= 0 && code >= extras;
  const int bit = (int)(lo >> (n > 0 ? n : 0)) & 1;
  return Code{extra ? (code << 1) - extras + bit : code,
              n >= 0 ? n + extra : 0};
}

// A lane's decoder state; M is the medians' type (int on the register
// path, long long on the peek path).
template <typename M>
struct Lane {
  long long zacc;
  M med[2][3];
  // hybrid state, read only by the hybrid profile
  long long slow[2], acc[2], delta[2], err[2];
  bool h1, h0, done;
  int ndec;
};

struct Tables {
  const int* log2t;
  const int* exp2t;
};

// One get_words iteration for channel C of an active lane, reading through
// `rd`; returns the residual (0 for a zero-run word or an EOF break) and,
// for WVC, the narrowed interval (0 where the word carries no correction
// code).
template <int C, bool MONO, bool HYBRID, bool BITRATE, bool BALANCE,
          bool WVC, typename M, class R>
__device__ __forceinline__ int decode_word(Lane<M>& s, R& rd,
                                           const Tables& tb, int& mc,
                                           int& base) {
  // ---- zero-run branch (WordsUtils.cs:304-352) ----
  if ((s.med[0][0] & ~(M)1) == 0 && (s.med[1][0] & ~(M)1) == 0 && !s.h1 &&
      !s.h0) {
    bool emit_zero = false;
    if (s.zacc > 0) {
      s.zacc -= 1;
      emit_zero = s.zacc > 0;
    } else {
      Gamma g = read_gamma(rd);
      if (g.broke) {
        s.done = true;
        return 0;
      }
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
  // The common case without branches that differ lane to lane: with
  // holding_zero set the count is 0 and nothing is read.
  const int t_u = rd.ones();
  long long oc;
  if (!s.h0 && t_u >= LIMIT_ONES) {  // an EOF break or a LIMIT_ONES escape
    if (t_u > LIMIT_ONES) {
      s.done = true;
      return 0;
    }
    rd.skip(LIMIT_ONES + 1);
    Gamma g = read_gamma(rd);
    if (g.broke) {
      s.done = true;
      return 0;
    }
    const long long raw = g.value + LIMIT_ONES;
    oc = (raw >> 1) + (s.h1 ? 1 : 0);
    s.h1 = (raw & 1) != 0;
    s.h0 = !s.h1;
  } else {
    rd.skip(s.h0 ? 0 : t_u + 1);
    oc = s.h0 ? 0 : (t_u >> 1) + (s.h1 ? 1 : 0);
    const bool h1 = !s.h0 && (t_u & 1) != 0;
    s.h0 = !s.h0 && !h1;
    s.h1 = h1;
  }

  // ---- hybrid error limit (WordsUtils.cs:430-431) ----
  if (HYBRID && C == 0)
    update_error_limit<MONO, BITRATE, BALANCE>(s.slow, s.acc, s.delta, s.err,
                                               tb.exp2t);

  // ---- median interval (WordsUtils.cs:433-475), as selects: every
  // candidate update is computed and the ones count picks ----
  M* m = s.med[C];
  const M g0 = (m[0] >> 4) + 1, g1 = (m[1] >> 4) + 1, g2 = (m[2] >> 4) + 1;
  const M d0 = med_dec<7>(m[0]), i0 = med_inc<7>(m[0]);
  const M d1 = med_dec<6>(m[1]), i1 = med_inc<6>(m[1]);
  const M d2 = med_dec<5>(m[2]), i2 = med_inc<5>(m[2]);
  const M width = oc == 0 ? g0 : oc == 1 ? g1 : g2;
  const long long low =
      oc == 0 ? 0
              : oc == 1 ? (long long)g0
                        : (long long)g0 + g1 + (oc - 2) * (long long)g2;
  m[0] = oc == 0 ? d0 : i0;
  m[1] = oc == 0 ? m[1] : oc == 1 ? d1 : i1;
  m[2] = oc < 2 ? m[2] : oc == 2 ? d2 : i2;

  // ---- value: read_code (WordsUtils.cs:546-570), or the hybrid search
  // where the error limit is not 0, and the sign bit ----
  const uint64_t win = rd.win();
  long long mid;
  int consume = 0;
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
    consume = (int)rc.consume;
  }
  const bool sign = (win >> consume) & 1;
  rd.skip(consume + 1);
  s.ndec += 1;
  if (BITRATE) s.slow[C] = slow_decay(s.slow[C]) + mylog2(mid, tb.log2t);
  return (int)wrap32(sign ? ~mid : mid);
}

// A step's value of each channel; a stereo pair in one 8-byte store (the
// outputs are fresh tensors, and a pair starts at an even index).
template <bool MONO>
__device__ __forceinline__ void store(int* dst, const int (&v)[2]) {
  if (MONO)
    dst[0] = v[0];
  else
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
}

// One step of a lane: channel A's word, then (stereo) channel B's.
template <bool MONO, bool HYBRID, bool BITRATE, bool BALANCE, bool WVC,
          typename M, class R>
__device__ __forceinline__ void decode_step(Lane<M>& s, R& rd,
                                            const Tables& tb, int (&v)[2],
                                            int (&mc)[2], int (&base)[2]) {
  v[0] = decode_word<0, MONO, HYBRID, BITRATE, BALANCE, WVC>(s, rd, tb,
                                                             mc[0], base[0]);
  if (!MONO && !s.done)
    v[1] = decode_word<1, MONO, HYBRID, BITRATE, BALANCE, WVC>(
        s, rd, tb, mc[1], base[1]);
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
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint32_t* row = words + (size_t)lane * W;
  const Stream st(row, W);

  // the peek path's state (long long medians), and the register path's
  Lane<long long> p;
  p.zacc = 0;
  p.h1 = p.h0 = p.done = false;
  p.ndec = 0;
  bool wide = false;
  for (int c = 0; c < 2; ++c) {
    for (int i = 0; i < 3; ++i) {
      p.med[c][i] = med0[lane * 6 + c * 3 + i];
      wide |= p.med[c][i] != wrap32(p.med[c][i]);
    }
    p.slow[c] = HYBRID ? slow0[lane * 2 + c] : 0;
    p.acc[c] = HYBRID ? acc0[lane * 2 + c] : 0;
    p.delta[c] = HYBRID ? delta0[lane * 2 + c] : 0;
    p.err[c] = 0;
  }
  Lane<int> f;
  f.zacc = 0;
  f.h1 = f.h0 = f.done = false;
  f.ndec = 0;
  for (int c = 0; c < 2; ++c) {
    for (int i = 0; i < 3; ++i) f.med[c][i] = (int)p.med[c][i];
    f.slow[c] = p.slow[c];
    f.acc[c] = p.acc[c];
    f.delta[c] = p.delta[c];
    f.err[c] = 0;
  }
  BitBuf bb;
  bb.start(row, W);
  PeekReader pr{st, 0};
  // the register path runs while a step starts before this position
  const int fast_end = (W - 1) * 32 - TAIL_BITS;
  bool fast = !wide;
  bool done = false;

  const int ns = nwords_lane[lane] / C;
  const size_t step = (size_t)L * C;
  size_t off = (size_t)lane * C;
  for (int t = 0; t < T; ++t, off += step) {
    int v[2] = {0, 0}, mc[2] = {0, 0}, base[2] = {0, 0};
    if (t < ns && !done) {
      if (fast && bb.pos >= fast_end) {  // hand the lane to the peek path
        fast = false;
        p.zacc = f.zacc;
        for (int c = 0; c < 2; ++c) {
          for (int i = 0; i < 3; ++i) p.med[c][i] = f.med[c][i];
          p.slow[c] = f.slow[c];
          p.acc[c] = f.acc[c];
          p.delta[c] = f.delta[c];
          p.err[c] = f.err[c];
        }
        p.h1 = f.h1;
        p.h0 = f.h0;
        p.ndec = f.ndec;
        pr.pos = bb.pos;
      }
      if (fast) {
        decode_step<MONO, HYBRID, BITRATE, BALANCE, WVC>(f, bb, tb, v, mc,
                                                         base);
        done = f.done;
      } else {
        decode_step<MONO, HYBRID, BITRATE, BALANCE, WVC>(p, pr, tb, v, mc,
                                                         base);
        done = p.done;
      }
    }
    store<MONO>(res + off, v);
    if (WVC) {
      store<MONO>(mc_out + off, mc);
      store<MONO>(base_out + off, base);
    }
  }
  broke[lane] = done ? 1 : 0;
  ndec[lane] = fast ? f.ndec : p.ndec;
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
