// Hybrid-lossless correction-stream decode for Hopper (sm_90a): one thread
// per lane.
//
// Replaces wvpk/ops/entropy.py::wvc_corrections, an XLA lax.scan and not a
// Pallas kernel: in eager PyTorch its plain version
// (wvpk_torch/ops/entropy.py::wvc_corrections) is a Python loop of ~10
// small launches per word, some 10^5 per bucket. The entropy kernel's wvc
// outputs already fixed each word's narrowed interval, so this scan only
// carries a bit cursor: each word with maxcode > 0 reads one minimal-binary
// code (read_code over maxcode, WordsUtils.cs:546-570) from the lane's
// correction stream, and the correction is base + code, negated where the
// lossy residual is negative (libwavpack's wvc semantics).
//
// What bounds it: the cursor makes a lane serial, so the parallelism is
// the lane count (~two warps per SM on a bench bucket); each word's
// dependent chain, and the reader's loads, set the time. It reads 12
// bytes and writes 4 per sample and channel, far below the card's memory
// bandwidth.
//
// Design: a word is a short chain on registers, with no branch.
// - The register bit reader of the entropy kernel (BitBuf, stream.cuh):
//   the lane's next 33 to 64 stream bits in a 64-bit register; the next
//   32-bit word is loaded one refill ahead, at an address that is a
//   counter, so no load waits on the cursor. A code takes at most 31 bits
//   (bit length 31: 30 bits and the extra one), so one refill a word
//   keeps 33 bits at hand. The refill (BitBuf::win, the entropy kernel's
//   too) is selects and a load from a clamped address with nothing
//   waiting on it, and prefetches the row's line 16 words ahead into L1:
//   the lanes of a warp refill at different words, so some lane's load is
//   read about every word, and one that missed L1 would stall the warp.
//   The launch asks for a shared-memory carve-out that leaves that L1 room
//   (stage.cuh, launch_staged): 1.71 ms without the hint, 1.65 with it, in
//   turns on an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py; PERF.md).
// - The row's tail: Stream::peek clamps a position past the start of the
//   row's last word to that start and reads the EOF fill after it, so a
//   damaged or short stream reads the same window again and again there:
//   the last word, then 0xFFFFFFFF. A word that starts past that point
//   reads that window; one that starts at or before it reads bits of the
//   row alone, which the register holds as peek does.
// - maxcode, base and the lossy residuals are staged ahead (stage.cuh, a
//   three-input ring): each thread copies its lane's next 32 steps into
//   shared memory with cp.async while it decodes the current 32.
// - A word with maxcode <= 0 reads nothing: its width is 0 and its
//   correction 0, by selects like the rest of the word.
// - 32-bit arithmetic, exact (the plain version forms code, base + code
//   and its negation in int64 and truncates the result to int32, wrap32):
//   a positive int32 maxcode has bit length b in 1..31, and the code's
//   b - 1 low bits, its extra bit and the cursor fit 32 bits (the wrapper
//   checks (W + T C) 32 < 2^31). extras = wrap32(1 << (b & 31)) - maxcode
//   - 1 (C#'s int shift, WordsUtils.cs:549) lies in [0, 2^(b-1)) for b <=
//   30, where the unsigned comparison with the code is the int64 one; for
//   b = 31 it is below -2^31, every code compares above it and reads the
//   extra bit, so that case is taken apart. Every later operation (shift
//   left, add, subtract, negate) commutes with reduction mod 2^32, so the
//   32-bit unsigned result is the int64 one mod 2^32, which is its wrap32.
// Inputs and outputs in the (T, L, C) layout, so a warp's accesses at one
// sample index are contiguous. One warp per block spreads the lanes over
// all SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"
#include "stream.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;
static_assert(THREADS == STAGE_LANES, "one staging column a thread");

struct Args {
  const uint32_t* wvc_words;
  const int *maxcode, *base, *residuals;
  int* corr;
  int L, W, T;
};

// The correction of one word of maxcode mc, read from the window `win`
// (>= 31 valid bits), without a branch; `consume` gets the bits it took.
// A maxcode <= 0 reads nothing and corrects by 0.
__device__ __forceinline__ uint32_t correction(uint64_t win, int mc,
                                               int base, int res,
                                               int& consume) {
  const int b = mc > 0 ? 32 - __clz(mc) : 0;          // 0..31
  const int n = max(b - 1, 0);                         // the code's bits
  const uint32_t extras = (1u << (b & 31)) - (uint32_t)mc - 1u;
  uint32_t code = (uint32_t)win & ((1u << n) - 1u);
  const bool extra = b > 0 && (b == 31 || code >= extras);
  code = extra ? (code << 1) - extras + ((uint32_t)(win >> n) & 1u) : code;
  consume = n + extra;
  const uint32_t mag = (uint32_t)base + code;
  return b == 0 ? 0u : res < 0 ? 0u - mag : mag;
}

template <bool MONO>
__global__ void __launch_bounds__(THREADS) wvc_kernel(Args a) {
  constexpr int C = MONO ? 1 : 2;
  using Ring = Stage<MONO, 2>;
  __shared__ __align__(16) int ring[ring_ints<MONO, 2>()];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.L) return;
  const uint32_t* row_words = a.wvc_words + (size_t)lane * a.W;
  BitBuf rd;
  rd.start(row_words, a.W);
  // Stream::peek past the last word's start: that word, then the EOF fill
  const int max_bit = (a.W - 1) * 32;
  const uint64_t tail =
      (uint64_t)__ldg(row_words + a.W - 1) | 0xFFFFFFFF00000000ull;

  const size_t row = (size_t)a.L * C;
  const size_t off = (size_t)lane * C;
  Ring st{ring + threadIdx.x * C, a.maxcode + off, a.base + off, row, a.T,
          a.residuals + off};
  int* o = a.corr + off;
  const int ntiles = (a.T + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
    const int t1 = min(k * TILE + TILE, a.T);
    for (int t = k * TILE; t < t1; ++t) {
      const int* v = st.at(t);
      int* op = o + (size_t)t * row;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint64_t w = rd.win();
        int consume;
        op[c] = (int)correction(rd.pos > max_bit ? tail : w, v[c],
                                v[2 * Ring::BUF + c], v[4 * Ring::BUF + c],
                                consume);
        rd.skip(consume);
      }
    }
  }
}

}  // namespace

// wvc_words (L, W) u32; maxcode, base, residuals and corr (T, L, C) int32;
// `device` the ordinal of the card they lie on. Returns the launch's CUDA
// error code.
extern "C" int wvpk_wvc_corrections(const void* wvc_words,
                                    const void* maxcode, const void* base,
                                    const void* residuals, void* corr, int L,
                                    int W, int T, int mono, int device,
                                    void* stream) {
  Args a{(const uint32_t*)wvc_words, (const int*)maxcode, (const int*)base,
         (const int*)residuals,      (int*)corr,          L,
         W,                          T};
  const void* fn = mono ? (const void*)wvc_kernel<true>
                        : (const void*)wvc_kernel<false>;
  void* params[] = {&a};
  const int blocks = (L + THREADS - 1) / THREADS;
  return (int)launch_staged(fn, blocks, device, params,
                            (cudaStream_t)stream);
}
