// DSD mode-3 ("high") decode for Hopper (sm_90a): one thread per lane,
// the filter bank in 32-bit registers.
//
// Replaces wvpk/ops/dsd_pallas.py::_dsd_high_kernel. The semantics are
// those of wvpk/ops/dsd.py::dsd_high_decode and of its port
// wvpk_torch/ops/dsd.py (the plain version): the binary arithmetic decoder
// of DsdUtils.cs:391-493 with its adaptive 256-entry probability table, and
// per channel the 6-stage leaky-integrator filter bank that predicts each
// bit; 8 bits per output byte, the channels of a stereo lane interleaved
// bit by bit in one coded stream. The XLA version holds the filters in
// int64 and wraps values to int32 where C#'s int arithmetic wraps.
//
// What bounds it: every bit's interval, table entry and filter state
// depend on the bit before, so a lane is one serial chain of 8 x channels
// bits a step and the only parallelism is the lane count; the kernel is
// bound by the latency of that chain (filter updates -> the next bit's
// table index -> its entry -> the split -> the bit), not by memory
// bandwidth (it reads each payload byte once and writes each output byte
// once).
//
// Design:
// - Two exact bodies in one kernel. The 32-bit body (Bank32, and the
//   ptable update in int32) runs every lane whose staged filters and
//   ptable lie in the range the parser gives them (f1..f5 in [0, 2^20],
//   |f6| <= 2^16, factor any int32; ptable entries in [-2^30, 2^30], the
//   parser's lie in [2^16, 2^24 + 2^16)); the int64 body (Bank64 and an
//   int64 ptable update, the XLA expressions with C#'s wraps) runs any
//   other lane and counts it in `wide` (0 on parsed streams).
// - The ptable lives in shared memory, one column per lane, strided as
//   pt[pp * LANES + lane] so that the lanes of a block hit different banks
//   (1 KB a lane); each thread copies and checks its own column. A block
//   is LANES lanes, so a 696-lane group is 87 blocks on 87 SMs, which
//   leaves room for the mode-1 groups beside it.
// - The payload comes through dsd_window.cuh's register window, one word
//   loaded a refill ahead; renormalisation is branch-free but its refill.
// - The 8 bits of a step and both channels are unrolled, so a channel's
//   filter update overlaps the coder's step on the other channel (only the
//   coder's interval is shared between them); the interval's (high - low)
//   >> 8 is taken once after each renormalisation.
// The CRC runs in channel order, and the loop stops at the lane's sample
// count (the XLA version keeps stepping and masks the outputs to 0).
//
// Why Bank32 is exact. Bank64 (the XLA expressions) computes in int64 and
// wraps with w32 (to int32, two's complement). Under the range above:
// - f1 += ((f0 & 2^20) - f1) >> 6 with f0 in {0, -1}: the target is 0 or
//   2^20 and x + floor((tgt - x) / 2^k) lies between x and tgt, so f1
//   stays in [0, 2^20]; the same for f2 (>> 4), f3 toward f2, f4 toward
//   f3, f5 += d = (f4 - f5) >> 4 toward f4. Every difference is in
//   [-2^20, 2^20], every sum in [0, 2^20]: nothing wraps, w32 is a no-op.
// - d is in [-2^16, 2^16], so f6 += (d - f6) >> 3 keeps |f6| <= 2^16.
// - f6 * factor: the int64 product's low 32 bits are the int32 wrapping
//   product, so w32(f6 * factor) is that product (computed unsigned here,
//   as C++ leaves signed overflow undefined); its >> 2 is in
//   [-2^29, 2^29), so val = f1 - f5 + (...) is in
//   [-2^29 - 2^20, 2^29 + 2^20]: no wrap.
// - v = val + f6 * 8 (|f6 * 8| <= 2^19) and v - f6 * 16 (|f6 * 16| <=
//   2^20) stay inside int32, and x >> 31 of an int32-range value is 0 or
//   -1 in both widths, so the factor's increment is the same -1, 0 or 1;
//   factor + increment wraps like w32 (computed unsigned).
// - factor -= (factor + 512) >> 10: (factor + 512) >> 10 is
//   (factor >> 10) + (((factor & 1023) + 512) >> 10), which cannot
//   overflow, and factor minus it has magnitude at most about
//   |factor| * 1023 / 1024 + 1, inside int32: w32 is a no-op.
// - The table index (val >> 8) & 255 and the byte's bits are the same.
// - The ptable update p += ((bit ? UP : DOWN) - p) >> 8: for p in
//   [-2^30, 2^30] the difference fits int32 and p moves toward its target
//   (UP or DOWN, both in [2^16, 2^25)) without passing it, so every entry
//   stays in [-2^30, 2^30] and w32 is a no-op.

#include <cstdint>
#include <cuda_runtime.h>

#include "dsd_window.cuh"

namespace {

constexpr int LANES = 8;  // lanes (threads) a block
constexpr int TABLE = 256;
constexpr long long UP = 0x010000FE, DOWN = 0x00010000;
constexpr int DECAY = 8;
constexpr int VALUE_ONE = 1 << 20;
constexpr int PP_SHIFT = 20 - 12;  // PRECISION - PRECISION_USE

__device__ __forceinline__ long long w32(long long x) {
  return (long long)(int32_t)(uint32_t)(uint64_t)x;
}

__device__ __forceinline__ int mul32(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// One channel's filter bank in int64, the XLA version's expressions.
struct Bank64 {
  long long f1, f2, f3, f4, f5, f6, factor, val;
  uint32_t byte;

  __device__ __forceinline__ void load(const int* f) {
    f1 = f[0], f2 = f[1], f3 = f[2], f4 = f[3], f5 = f[4], f6 = f[5];
    factor = f[6];
  }
  // the per-sample predictor seed (DsdUtils.cs:401-404)
  __device__ __forceinline__ void seed() {
    val = w32(f1 - f5 + (w32(f6 * factor) >> 2));
    byte = 0;
  }
  __device__ __forceinline__ int index() const {
    return (int)((val >> PP_SHIFT) & (TABLE - 1));
  }
  __device__ __forceinline__ void update(bool one) {
    const long long f0 = one ? -1 : 0;
    const long long v = w32(val + w32(f6 * 8));
    byte = (byte << 1) | (one ? 1u : 0u);
    factor = w32(factor + ((((v ^ f0) >> 31) | 1) &
                           ((v ^ w32(v - w32(f6 * 16))) >> 31)));
    f1 = w32(f1 + (((f0 & VALUE_ONE) - f1) >> 6));
    f2 = w32(f2 + (((f0 & VALUE_ONE) - f2) >> 4));
    f3 = w32(f3 + ((f2 - f3) >> 4));
    f4 = w32(f4 + ((f3 - f4) >> 4));
    const long long d = (f4 - f5) >> 4;
    f5 = w32(f5 + d);
    f6 = w32(f6 + ((d - f6) >> 3));
    val = w32(f1 - f5 + (w32(f6 * factor) >> 2));
  }
  __device__ __forceinline__ void decay() {
    factor = w32(factor - ((factor + 512) >> 10));
  }
};

// The same bank in 32-bit registers, for the range proven above.
struct Bank32 {
  int f1, f2, f3, f4, f5, f6, factor, val;
  uint32_t byte;

  static __device__ __forceinline__ bool fits(const int* f) {
    bool ok = f[5] >= -(1 << 16) && f[5] <= (1 << 16);
    for (int i = 0; i < 5; ++i) ok &= f[i] >= 0 && f[i] <= VALUE_ONE;
    return ok;
  }
  __device__ __forceinline__ void load(const int* f) {
    f1 = f[0], f2 = f[1], f3 = f[2], f4 = f[3], f5 = f[4], f6 = f[5];
    factor = f[6];
  }
  __device__ __forceinline__ void seed() {
    val = f1 - f5 + (mul32(f6, factor) >> 2);
    byte = 0;
  }
  __device__ __forceinline__ int index() const {
    return (val >> PP_SHIFT) & (TABLE - 1);
  }
  __device__ __forceinline__ void update(bool one) {
    const int f0 = one ? -1 : 0;
    const int v = val + f6 * 8;
    byte = (byte << 1) | (one ? 1u : 0u);
    factor = add32(factor, (((v ^ f0) >> 31) | 1) &
                               ((v ^ (v - f6 * 16)) >> 31));
    const int tgt = f0 & VALUE_ONE;
    f1 += (tgt - f1) >> 6;
    f2 += (tgt - f2) >> 4;
    f3 += (f2 - f3) >> 4;
    f4 += (f3 - f4) >> 4;
    const int d = (f4 - f5) >> 4;
    f5 += d;
    f6 += (d - f6) >> 3;
    val = f1 - f5 + (mul32(f6, factor) >> 2);
  }
  __device__ __forceinline__ void decay() {
    factor -= (factor >> 10) + (((factor & 1023) + 512) >> 10);
  }
};

// The binary coder's state; range8 is (high - low) >> 8. P32: the ptable
// update in int32 (the 32-bit body's range), else in int64.
template <bool P32>
struct Coder {
  uint32_t value, low, high, range8;
  int bptr, nb;
  dsd::Window<dsd::ThreadWords> win;

  // One bit with the ptable entry `e` (DsdUtils.cs:406-425).
  __device__ __forceinline__ bool bit(int* e) {
    const int p32 = *e;
    const uint32_t split = low + range8 * ((uint32_t)p32 >> 16);
    const bool one = value <= split;
    if (one) {
      high = split;
    } else {
      low = split + 1;
    }
    if (P32) {
      const int tgt = one ? (int)UP : (int)DOWN;
      *e = p32 + ((tgt - p32) >> DECAY);
    } else {
      long long p = p32;
      p += ((one ? UP : DOWN) - p) >> DECAY;
      *e = (int)w32(p);
    }
    dsd::renorm(high, low, value, bptr, win, nb);
    range8 = (high - low) >> 8;
    return one;
  }
};

// A lane's whole decode with the filter bank Bank and the ptable update
// of Coder<P32>: the byte-values into orow, the CRC into crc_out.
template <bool MONO, class Bank, bool P32>
__device__ __forceinline__ void decode_lane(
    const uint8_t* data, const int* nbytes, const long long* value0,
    const int* filters, int* pt, int lane, int NB, int stop, int nsteps,
    uint32_t* orow, uint32_t& crc_out) {
  constexpr int C = MONO ? 1 : 2;
  Coder<P32> cd;
  cd.win.src.start(reinterpret_cast<const uint32_t*>(data + (size_t)lane * NB),
                   NB / 4);
  cd.win.fill();
  cd.value = (uint32_t)value0[lane];
  cd.low = 0;
  cd.high = 0xFFFFFFFFu;
  cd.range8 = cd.high >> 8;
  cd.bptr = 0;
  cd.nb = nbytes[lane];
  Bank ch[C];
#pragma unroll
  for (int c = 0; c < C; ++c) ch[c].load(filters + c * 8);
  uint32_t crc = 0xFFFFFFFFu, word = 0;
  int t = 0;
  for (; t < stop; ++t) {
#pragma unroll
    for (int c = 0; c < C; ++c) ch[c].seed();
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        ch[c].update(cd.bit(pt + ch[c].index() * LANES));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t code = ch[c].byte & 0xFF;
      crc = crc * 3 + code;
      ch[c].decay();
      const int pos = t * C + c;
      word |= code << (8 * (pos & 3));
      if ((pos & 3) == 3) {
        orow[pos >> 2] = word;
        word = 0;
      }
    }
  }
  // the partial word, then zeros to the end of the row
  for (int w = (t * C) >> 2; w < nsteps * C / 4; ++w) {
    orow[w] = word;
    word = 0;
  }
  crc_out = crc;
}

template <bool MONO>
__global__ void __launch_bounds__(LANES)
dsd_high_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ nbytes,
                const int* __restrict__ ptable0,
                const int* __restrict__ filters0,
                const long long* __restrict__ value0,
                const int* __restrict__ nsamples, uint8_t* __restrict__ out,
                int* __restrict__ crc_out, int* __restrict__ wide, int L,
                int NB, int nsteps) {
  constexpr int C = MONO ? 1 : 2;
  __shared__ int pt_all[TABLE * LANES];
  const int lane = blockIdx.x * LANES + threadIdx.x;
  if (lane >= L) return;
  // this thread's column: entry e of its lane at pt[e * LANES]
  int* pt = pt_all + threadIdx.x;
  bool pt32 = true;
#pragma unroll 8
  for (int e = 0; e < TABLE; ++e) {
    const int v = __ldg(ptable0 + (size_t)lane * TABLE + e);
    pt32 &= v >= -(1 << 30) && v <= (1 << 30);
    pt[e * LANES] = v;
  }
  // the lane's nsteps * C output bytes in (sample, channel) order
  uint32_t* orow =
      reinterpret_cast<uint32_t*>(out + (size_t)lane * nsteps * C);
  const int stop = nsamples[lane] < nsteps ? nsamples[lane] : nsteps;
  const int* f = filters0 + (size_t)lane * 16;
  uint32_t crc;
  if (pt32 && Bank32::fits(f) && (MONO || Bank32::fits(f + 8))) {
    decode_lane<MONO, Bank32, true>(data, nbytes, value0, f, pt, lane, NB,
                                    stop, nsteps, orow, crc);
  } else {
    atomicAdd(wide, 1);
    decode_lane<MONO, Bank64, false>(data, nbytes, value0, f, pt, lane, NB,
                                     stop, nsteps, orow, crc);
  }
  crc_out[lane] = (int)crc;
}

}  // namespace

// data (L, NB) uint8, NB a multiple of 4; nbytes, nsamples (L,) int32,
// each nbytes at most NB; ptable0 (L, 256) int32; filters0 (L, 2, 8) int32
// (f1..f5, f6, factor per channel); value0 (L,) int64; out (L, nsteps * C)
// uint8, nsteps * C a multiple of 4; crc (L,) int32; wide (1,) int32, to
// which the kernel adds the lanes it ran in the int64 body. Returns the
// launch's CUDA error code.
extern "C" int wvpk_dsd_high_decode(const void* data, const void* nbytes,
                                    const void* ptable0,
                                    const void* filters0,
                                    const void* value0,
                                    const void* nsamples, void* out,
                                    void* crc, void* wide, int L, int NB,
                                    int nsteps, int mono, void* stream) {
  if (NB < 4 || NB % 4 != 0 || (nsteps * (mono ? 1 : 2)) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + LANES - 1) / LANES), block(LANES);
  cudaStream_t s = (cudaStream_t)stream;
  auto* d = (const uint8_t*)data;
  auto* nb = (const int*)nbytes;
  auto* p0 = (const int*)ptable0;
  auto* f0 = (const int*)filters0;
  auto* v0 = (const long long*)value0;
  auto* ns = (const int*)nsamples;
  if (mono)
    dsd_high_kernel<true><<<grid, block, 0, s>>>(
        d, nb, p0, f0, v0, ns, (uint8_t*)out, (int*)crc, (int*)wide, L, NB,
        nsteps);
  else
    dsd_high_kernel<false><<<grid, block, 0, s>>>(
        d, nb, p0, f0, v0, ns, (uint8_t*)out, (int*)crc, (int*)wide, L, NB,
        nsteps);
  return (int)cudaGetLastError();
}
