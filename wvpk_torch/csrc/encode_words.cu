// Lossless entropy word encoding for Hopper (sm_90a): one thread per lane,
// writing the lane's payload bits straight into its row.
//
// Replaces wvpk/ops/encode_pallas.py::_encode_words_kernel
// (entropy_encode_pallas). Its plain version is wvpk_torch/ops/
// encode_pack.py::pack_segments_device over ops/encode_kernels.py::
// entropy_encode_words: the same bits, in the same order, as the word
// automaton's slots packed one after another, the final flush of the
// pending word included. The automaton is the reference decoder's
// get_words (WordsUtils.cs:272-511) run forward: zero runs where the
// medians are tiny, unary ones counts with the holding carry (a word's
// unary count is written once the next word's first bit is known), the
// LIMIT_ONES escape with its gamma, the median intervals and the
// minimal-binary value codes with their sign bits.
//
// What bounds it: a lane's bit cursor is a serial chain through every
// word, so the parallelism is the lane count, as in the decoder. Each word
// costs a handful of dependent integer operations and one 64-bit division
// (the ones count beyond the second median). Device memory moves 4 bytes in
// per word and the payload out (~1 byte per word at 16-bit audio).
//
// Design: the Pallas kernel emits fixed-size segments per word (seven
// int32 planes) for a scatter pass to pack; a thread here owns its lane's
// cursor, so it packs as it goes through a 64-bit accumulator and stores
// each completed 32-bit word: no segment planes, no pack pass. Zero-run
// lengths come from a look-ahead over the lane's words when a run starts
// (each word is read at most twice), not a precomputed suffix scan. The
// division is native (the Pallas kernel's two f32-reciprocal stages are a
// TPU workaround). Words in (W, L) layout make a warp's loads at one word
// index contiguous; the payload rows are zero-filled by the caller, so the
// bytes past each lane's end are zero.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_bits.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

template <bool MONO>
__global__ void __launch_bounds__(THREADS)
words_kernel(const int* __restrict__ res, const long long* __restrict__ med0,
             const int* __restrict__ nvals, uint32_t* __restrict__ out,
             long long* __restrict__ total, int L, int W, int cap) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  long long med[2][3];
  for (int c = 0; c < 2; ++c)
    for (int i = 0; i < 3; ++i) med[c][i] = med0[lane * 6 + c * 3 + i];
  const int nv = min(nvals[lane], W);
  Writer bw(out + (size_t)lane * cap, cap);
  Pending pend;
  long long zacc = 0;

  for (int w = 0; w < nv; ++w) {
    const int c = MONO ? 0 : (w & 1);
    const long long r = res[(size_t)w * L + lane];
    if (pend.clear && (med[0][0] & ~1LL) == 0 && (med[1][0] & ~1LL) == 0) {
      if (zacc > 0) {
        if (--zacc > 0) continue;        // inside a run: nothing written
      } else {
        // the run starting here: its length, then gamma(length)
        int z = 0;
        while (w + z < nv && res[(size_t)(w + z) * L + lane] == 0) ++z;
        put_gamma(bw, z);
        if (z > 0) {
          zacc = z;
          for (int k = 0; k < 2; ++k)
            for (int i = 0; i < 3; ++i) med[k][i] = 0;
          continue;
        }
      }
    }
    const bool sign = r < 0;
    const long long av = sign ? ~r : r;
    long long low, high;
    const long long oc = ones_count(av, med[c], low, high);
    median_update(med[c], oc);
    int vl;
    const uint64_t vb = value_code(av, low, high, vl);
    pend.code(bw, oc, vb | ((uint64_t)sign << vl), vl + 1);
  }
  pend.finish(bw);
  bw.finish();
  total[lane] = bw.total;
}

}  // namespace

// res (W, L) int32 residual words (stereo: channel-interleaved per sample);
// med0 (L, 2, 3) int64 quantized non-negative medians; nvals (L,) int32
// valid words; out (L, cap) uint32 payload rows, zero-filled by the
// caller; total (L,) int64 payload bits. Returns the launch's CUDA error
// code.
extern "C" int wvpk_encode_words(const void* res, const void* med0,
                                 const void* nvals, void* out, void* total,
                                 int L, int W, int cap, int mono,
                                 void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (mono)
    words_kernel<true><<<grid, block, 0, s>>>(
        (const int*)res, (const long long*)med0, (const int*)nvals,
        (uint32_t*)out, (long long*)total, L, W, cap);
  else
    words_kernel<false><<<grid, block, 0, s>>>(
        (const int*)res, (const long long*)med0, (const int*)nvals,
        (uint32_t*)out, (long long*)total, L, W, cap);
  return (int)cudaGetLastError();
}
