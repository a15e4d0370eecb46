// DSD mode-3 ("high") decode for Hopper (sm_90a): one thread per lane.
//
// Replaces wvpk/ops/dsd_pallas.py::_dsd_high_kernel. The semantics are
// those of wvpk/ops/dsd.py::dsd_high_decode and of its port
// wvpk_torch/ops/dsd.py (the plain version): the binary arithmetic decoder
// of DsdUtils.cs:391-493 with its adaptive 256-entry probability table, and
// per channel the 6-stage leaky-integrator filter bank that predicts each
// bit; 8 bits per output byte, the channels of a stereo lane interleaved
// bit by bit in one coded stream. The filter arithmetic is the XLA
// version's, expression by expression: int64 values wrapped to int32 where
// it wraps them (C#'s int overflow), so the kernel and the plain version
// agree bit for bit whatever the stream holds.
//
// What bounds it: every bit's interval, table entry and filter state depend
// on the bit before, so a lane is one serial chain of 8 x channels bits per
// step and the only parallelism is the lane count (~700 lanes a group in
// the bench shape). The kernel is bound by the latency of that chain, not
// by memory bandwidth (it reads each payload byte once and writes each
// output byte once, four at a time into the lane's row of the delivered
// bytes: no separate pack).
//
// Design: the ptable lives in shared memory, one column per thread,
// strided as pt[pp * blockDim.x + threadIdx.x] so that the 32 threads of a
// warp always hit 32 different banks (1 KB per lane, 32 KB per block of
// 32 threads: under the 48 KB a block gets without opting in). A read and
// a write of one entry replace the Pallas kernel's 256-row one-hot
// select-reduce; the coder and the filters f1-f6, factor, value and the
// byte being built stay in registers; renormalisation is the closed form
// min(clz(high ^ low) >> 3, bytes left), read from the lane's uint8 row.
// The CRC runs in the loop in channel order, and the loop stops at the
// lane's sample count (the XLA version keeps stepping and masks the
// outputs to 0: the results are the same).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int TABLE = 256;
constexpr long long UP = 0x010000FE, DOWN = 0x00010000;
constexpr int DECAY = 8;
constexpr long long VALUE_ONE = 1LL << 20;
constexpr int PP_SHIFT = 20 - 12;  // PRECISION - PRECISION_USE

__device__ __forceinline__ long long w32(long long x) {
  return (long long)(int32_t)(uint32_t)(uint64_t)x;
}

__device__ __forceinline__ uint32_t be4(const uint8_t* row, int cap,
                                        int pos) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i) {
    int p = pos + i < cap ? pos + i : cap - 1;
    v = (v << 8) | row[p];
  }
  return v;
}

__device__ __forceinline__ void renorm(uint32_t& high, uint32_t& low,
                                       uint32_t& value, int& bptr,
                                       const uint8_t* row, int cap,
                                       int nbytes) {
  int k = __clz((int)(high ^ low)) >> 3;
  int left = nbytes - bptr;
  left = left < 0 ? 0 : (left > 4 ? 4 : left);
  if (k > left) k = left;
  if (k == 0) return;
  uint32_t w = be4(row, cap, bptr);
  if (k == 4) {
    value = w;
    high = 0xFFFFFFFFu;
    low = 0;
  } else {
    int sh = 8 * k;
    value = (value << sh) | (w >> (32 - sh));
    high = (high << sh) | ((1u << sh) - 1);
    low <<= sh;
  }
  bptr += k;
}

struct Filters {
  long long f1, f2, f3, f4, f5, f6, factor, val, bytei;
};

template <bool MONO>
__global__ void __launch_bounds__(THREADS)
dsd_high_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ nbytes,
                const int* __restrict__ ptable0,
                const int* __restrict__ filters0,
                const long long* __restrict__ value0,
                const int* __restrict__ nsamples, uint8_t* __restrict__ out,
                int* __restrict__ crc_out, int L, int NB, int nsteps) {
  constexpr int C = MONO ? 1 : 2;
  extern __shared__ int pt_all[];
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  // each thread reads and writes only its own column: no barrier needed
  int* pt = pt_all + threadIdx.x;
  const int S = blockDim.x;
  for (int i = 0; i < TABLE; ++i)
    pt[i * S] = ptable0[(size_t)lane * TABLE + i];
  const uint8_t* row = data + (size_t)lane * NB;
  // the lane's nsteps * C output bytes in (sample, channel) order, written
  // a 4-byte word at a time
  uint32_t* orow =
      reinterpret_cast<uint32_t*>(out + (size_t)lane * nsteps * C);
  uint32_t word = 0;
  const int nb = nbytes[lane];
  const int stop = nsamples[lane] < nsteps ? nsamples[lane] : nsteps;
  Filters ch[C];
  for (int c = 0; c < C; ++c) {
    const int* f = filters0 + ((size_t)lane * 2 + c) * 8;
    ch[c] = Filters{f[0], f[1], f[2], f[3], f[4], f[5], f[6], 0, 0};
  }
  uint32_t value = (uint32_t)value0[lane], low = 0, high = 0xFFFFFFFFu;
  uint32_t crc = 0xFFFFFFFFu;
  int bptr = 0;
  int t = 0;
  for (; t < stop; ++t) {
    // per-sample predictor seed (DsdUtils.cs:401-404)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Filters& q = ch[c];
      q.val = w32(q.f1 - q.f5 + (w32(q.f6 * q.factor) >> 2));
      q.bytei = 0;
    }
    for (int bit = 0; bit < 8; ++bit) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        Filters& q = ch[c];
        const int pp = (int)((q.val >> PP_SHIFT) & (TABLE - 1));
        long long p = pt[pp * S];
        const uint32_t split =
            low + ((high - low) >> 8) * ((uint32_t)(int)p >> 16);
        const bool one = value <= split;
        if (one) {
          high = split;
          p += (UP - p) >> DECAY;
        } else {
          low = split + 1;
          p += (DOWN - p) >> DECAY;
        }
        pt[pp * S] = (int)w32(p);
        const long long f0 = one ? -1 : 0;
        renorm(high, low, value, bptr, row, NB, nb);
        long long v = w32(q.val + w32(q.f6 * 8));
        q.bytei = w32((q.bytei << 1) | (f0 & 1));
        q.factor = w32(q.factor + ((((v ^ f0) >> 31) | 1) &
                                   ((v ^ w32(v - w32(q.f6 * 16))) >> 31)));
        q.f1 = w32(q.f1 + (((f0 & VALUE_ONE) - q.f1) >> 6));
        q.f2 = w32(q.f2 + (((f0 & VALUE_ONE) - q.f2) >> 4));
        q.f3 = w32(q.f3 + ((q.f2 - q.f3) >> 4));
        q.f4 = w32(q.f4 + ((q.f3 - q.f4) >> 4));
        const long long d = (q.f4 - q.f5) >> 4;
        q.f5 = w32(q.f5 + d);
        q.f6 = w32(q.f6 + ((d - q.f6) >> 3));
        q.val = w32(q.f1 - q.f5 + (w32(q.f6 * q.factor) >> 2));
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Filters& q = ch[c];
      const int code = (int)(q.bytei & 0xFF);
      crc = crc * 3 + (uint32_t)code;
      q.factor = w32(q.factor - ((q.factor + 512) >> 10));
      const int pos = t * C + c;
      word |= (uint32_t)code << (8 * (pos & 3));
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
  crc_out[lane] = (int)crc;
}

}  // namespace

// data (L, NB) uint8; nbytes, nsamples (L,) int32; ptable0 (L, 256) int32;
// filters0 (L, 2, 8) int32 (f1..f5, f6, factor per channel); value0 (L,)
// int64; out (L, nsteps * C) uint8, nsteps * C a multiple of 4; crc (L,)
// int32. Returns the launch's CUDA error code.
extern "C" int wvpk_dsd_high_decode(const void* data, const void* nbytes,
                                    const void* ptable0,
                                    const void* filters0,
                                    const void* value0,
                                    const void* nsamples, void* out,
                                    void* crc, int L, int NB, int nsteps,
                                    int mono, void* stream) {
  if (NB < 1 || (nsteps * (mono ? 1 : 2)) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  const size_t smem = (size_t)TABLE * THREADS * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  auto* d = (const uint8_t*)data;
  auto* nb = (const int*)nbytes;
  auto* p0 = (const int*)ptable0;
  auto* f0 = (const int*)filters0;
  auto* v0 = (const long long*)value0;
  auto* ns = (const int*)nsamples;
  if (mono)
    dsd_high_kernel<true><<<grid, block, smem, s>>>(
        d, nb, p0, f0, v0, ns, (uint8_t*)out, (int*)crc, L, NB, nsteps);
  else
    dsd_high_kernel<false><<<grid, block, smem, s>>>(
        d, nb, p0, f0, v0, ns, (uint8_t*)out, (int*)crc, L, NB, nsteps);
  return (int)cudaGetLastError();
}
