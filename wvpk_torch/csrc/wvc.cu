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
// the lane count (~two warps per SM on a bench bucket); each thread's
// dependent window loads and its branch per word set the time. It reads
// 12 bytes and writes 4 per sample and channel, far below the card's
// memory bandwidth.
//
// Design: the same 64-bit window over the lane's words as the entropy
// kernel (csrc/stream.cuh); inputs and outputs in the (T, L, C) layout, so
// a warp's accesses at one sample index are contiguous. One warp per block
// spreads the lanes over all SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

template <int C>
__global__ void __launch_bounds__(THREADS)
wvc_kernel(const uint32_t* __restrict__ wvc_words,
           const int* __restrict__ maxcode, const int* __restrict__ base,
           const int* __restrict__ residuals, int* __restrict__ corr, int L,
           int W, int T) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  Stream st(wvc_words + (size_t)lane * W, W);
  long long bitpos = 0;
  const size_t row = (size_t)L * C;
  size_t off = (size_t)lane * C;
  for (int t = 0; t < T; ++t, off += row) {
    for (int c = 0; c < C; ++c) {
      const long long mc = maxcode[off + c];
      int v = 0;
      if (mc > 0) {
        Code rc = read_code(st.peek(bitpos), mc);
        bitpos += rc.consume;
        long long mag = base[off + c] + rc.code;
        v = (int)wrap32(residuals[off + c] < 0 ? -mag : mag);
      }
      corr[off + c] = v;
    }
  }
}

}  // namespace

// wvc_words (L, W) u32; maxcode, base, residuals and corr (T, L, C) int32.
// Returns the launch's CUDA error code.
extern "C" int wvpk_wvc_corrections(const void* wvc_words,
                                    const void* maxcode, const void* base,
                                    const void* residuals, void* corr, int L,
                                    int W, int T, int mono, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  auto w = (const uint32_t*)wvc_words;
  auto mc = (const int*)maxcode;
  auto b = (const int*)base;
  auto r = (const int*)residuals;
  if (mono)
    wvc_kernel<1><<<grid, block, 0, s>>>(w, mc, b, r, (int*)corr, L, W, T);
  else
    wvc_kernel<2><<<grid, block, 0, s>>>(w, mc, b, r, (int*)corr, L, W, T);
  return (int)cudaGetLastError();
}
