// INT32 wvx low-bit injection for Hopper (sm_90a): one thread per lane.
//
// Replaces wvpk/ops/post.py::wvx_inject, an XLA lax.scan and not a Pallas
// kernel: in eager PyTorch its plain version (wvpk_torch/ops/post.py::
// wvx_inject) is a Python loop of ~40 small launches per value. For each
// value in interleaved order (UnpackUtils.cs:1271-1314) it reads the
// sent_bits low bits the encoder moved to the wvx stream (fewer where
// max_width truncates), through the reference's getbits window: a bit
// count `bc` refilled in byte steps, a window of min(bc, 32) bits masked to
// sent_bits (mod-32 shifts, as in C#). Then the zeros/ones/dups
// re-expansion and the crc_x recurrence (crc = 9 crc + 3 lo16 + hi16). A
// FALSE_STEREO lane runs a second pass over zeros, as the reference's
// fixup does over the zero half of its buffer (UnpackUtils.cs:1265): it
// moves only the cursor and crc_x.
//
// What bounds it: how many bits a value takes depends on the value, so a
// lane is serial and the parallelism is the lane count; each thread's
// dependent window loads and branches set the time, not memory bandwidth
// (8 bytes read and written per value).
//
// Design: the 64-bit window of csrc/stream.cuh over the lane's words;
// values in the (T, L, C) layout, so a warp's accesses at one sample index
// are contiguous; one warp per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

struct Cursor {
  long long bitpos, bc, crc;
};

struct Params {
  long long sb, mask, mw, zeros, ones, dups;
};

// One value: injection, re-expansion and crc_x, for a valid position.
__device__ __forceinline__ long long one_value(long long v, Cursor& cur,
                                               const Params& p,
                                               const Stream& st) {
  long long v1 = v;
  if (p.sb > 0) {
    long long pvalue = v < 0 ? ~v : v;
    long long width = bit_length(pvalue) + p.sb;
    bool truncated = p.mw > 0 && width > p.mw;
    long long btr = truncated ? p.sb - (width - p.mw) : p.sb;
    if (!truncated || btr > 0) {
      long long need = btr - cur.bc > 0 ? btr - cur.bc : 0;
      long long bc_pre = cur.bc + (((need + 7) >> 3) << 3);
      long long data =
          bits_of(st.peek(cur.bitpos), bc_pre < 32 ? bc_pre : 32) & p.mask;
      v1 = wrap32(shl(wrap32(wrap32(shl(v, btr & 31)) | data),
                      (p.sb - btr) & 31));
      cur.bitpos += btr;
      cur.bc = bc_pre - btr;
    } else {
      v1 = wrap32(shl(v, p.sb & 31));
    }
  }
  // re-expansion (UnpackUtils.cs:1316-1343)
  long long v2;
  if (p.zeros != 0)
    v2 = wrap32(shl(v1, p.zeros & 31));
  else if (p.ones != 0)
    v2 = wrap32(shl(v1 + 1, p.ones & 31) - 1);
  else if (p.dups != 0)
    v2 = wrap32(shl(v1 + (v1 & 1), p.dups & 31) - (v1 & 1));
  else
    v2 = v1;
  cur.crc = wrap32(cur.crc * 9 + (v2 & 0xFFFF) * 3 + ((v2 >> 16) & 0xFFFF));
  return v2;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
wvx_kernel(const int* __restrict__ in, const int* __restrict__ nsamples,
           const uint32_t* __restrict__ wvx_words,
           const int* __restrict__ start_bit, const int* __restrict__ start_bc,
           const int* __restrict__ sent_bits,
           const int* __restrict__ max_width, const int* __restrict__ zod,
           const int* __restrict__ false_stereo, int* __restrict__ out,
           int* __restrict__ crc_x, int L, int W, int T) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  Stream st(wvx_words + (size_t)lane * W, W);
  Params p;
  p.sb = sent_bits[lane];
  p.mask = (1LL << (p.sb & 31)) - 1;
  p.mw = max_width[lane];
  p.zeros = zod[lane * 3];
  p.ones = zod[lane * 3 + 1];
  p.dups = zod[lane * 3 + 2];
  Cursor cur{start_bit[lane], start_bc[lane], -1};
  const int ns = nsamples[lane];
  const size_t row = (size_t)L * C;
  size_t off = (size_t)lane * C;
  for (int t = 0; t < T; ++t, off += row) {
    for (int c = 0; c < C; ++c) {
      long long v = in[off + c];
      out[off + c] = (int)(t < ns ? one_value(v, cur, p, st) : v);
    }
  }
  if (false_stereo != nullptr && false_stereo[lane])
    for (int t = 0; t < ns && t < T; ++t) one_value(0, cur, p, st);
  crc_x[lane] = (int)cur.crc;
}

}  // namespace

// in/out (T, L, C) int32; nsamples, start_bit, start_bc, sent_bits,
// max_width (L,) int32; wvx_words (L, W) u32; zod (L, 3) int32;
// false_stereo (L,) int32 or null; crc_x (L,) int32. Returns the launch's
// CUDA error code.
extern "C" int wvpk_wvx_inject(const void* in, const void* nsamples,
                               const void* wvx_words, const void* start_bit,
                               const void* start_bc, const void* sent_bits,
                               const void* max_width, const void* zod,
                               const void* false_stereo, void* out,
                               void* crc_x, int L, int W, int T, int mono,
                               void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define WVPK_WVX_ARGS                                                       \
  (const int*)in, (const int*)nsamples, (const uint32_t*)wvx_words,        \
      (const int*)start_bit, (const int*)start_bc, (const int*)sent_bits,  \
      (const int*)max_width, (const int*)zod, (const int*)false_stereo,    \
      (int*)out, (int*)crc_x, L, W, T
  if (mono)
    wvx_kernel<1><<<grid, block, 0, s>>>(WVPK_WVX_ARGS);
  else
    wvx_kernel<2><<<grid, block, 0, s>>>(WVPK_WVX_ARGS);
#undef WVPK_WVX_ARGS
  return (int)cudaGetLastError();
}
