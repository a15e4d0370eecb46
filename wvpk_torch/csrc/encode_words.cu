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
// word, so the parallelism is the lane count, as in the decoder (~8,300
// lanes: about two warps per SM). A launch takes as long as one lane's
// chain of dependent operations. Device memory moves 4 bytes in per word
// and the payload out (~1 byte per word at 16-bit audio): ~0.1 ms.
//
// Design: a word's chain is kept short (encode_bits.cuh).
// - A stereo sample's two words (channel A, then B) are one iteration, so
//   every median index is a constant and the medians are registers (a
//   run-time channel index kept them in local memory). A lane whose word
//   count is odd ends after an A word.
// - 32-bit medians, intervals and codes, proven exact in encode_bits.cuh
//   for lanes whose staged medians fit int32 (every staged lane: the
//   quantized medians are exp2s values). Any other lane runs the same
//   coder with int64 medians in the same kernel; the launch counts those
//   lanes (`wide`).
// - No 64-bit division: the ones count past the second median takes a
//   compare ladder for quotients 0-3 and a 32-bit division beyond.
// - The median update, the value code and the holding transitions are
//   selects; real branches remain for zero runs, LIMIT_ONES escapes and
//   their gammas, which are rare and mostly taken by a whole warp.
// - The residual words are staged ahead (stage.cuh): each thread copies
//   its lane's next 32 words into a double-buffered ring in shared memory
//   with cp.async while it codes the current 32, so no word's load sits
//   on the chain. A zero run's look-ahead, which may reach past the staged
//   words to the lane's end, reads device memory, four words a step.
// - A thread packs its lane's bits as it goes through a 64-bit accumulator
//   and stores each completed 32-bit word: no segment planes, no pack pass
//   (the Pallas kernel emits fixed-size segments for a scatter pass).
// Words in (W, L) layout make a warp's loads at one word index contiguous;
// the payload rows are zero-filled by the caller, so the bytes past each
// lane's end are zero.

#include <cstdint>
#include <cuda_runtime.h>

#include "encode_bits.cuh"
#include "stage.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;
static_assert(THREADS == STAGE_LANES, "one staging column a thread");

struct Args {
  const int* res;
  const long long* med0;
  const int* nvals;
  uint32_t* out;
  long long* total;
  int* wide;
  int L, W, cap;
};

// The consecutive zero words of a lane's column from word w on, up to its
// word count nv.
__device__ __forceinline__ int zero_run(const int* col, size_t L, int w,
                                        int nv) {
  int z = w;
  while (z + 4 <= nv) {
    const int a = __ldg(col + (size_t)z * L);
    const int b = __ldg(col + (size_t)(z + 1) * L);
    const int c = __ldg(col + (size_t)(z + 2) * L);
    const int d = __ldg(col + (size_t)(z + 3) * L);
    if ((a | b | c | d) != 0) break;
    z += 4;
  }
  while (z < nv && __ldg(col + (size_t)z * L) == 0) ++z;
  return z - w;
}

template <typename M>
struct Coder {
  M med[2][3];
  Pending<Count<M>> pend;
  int zacc;          // words left in the current zero run
  Writer bw;
  const int* col;    // the lane's column of the words
  size_t L;
  int nv;

  // Word w of channel C, residual r.
  template <int C>
  __device__ __forceinline__ void word(int r, int w) {
    if (!pend.valid && (med[0][0] & ~(M)1) == 0 &&
        (med[1][0] & ~(M)1) == 0) {
      if (zacc > 0) {
        if (--zacc > 0) return;          // inside a run: nothing written
      } else {
        // the run starting here: its length, then gamma(length)
        const int z = zero_run(col, L, w, nv);
        put_gamma(bw, z);
        if (z > 0) {
          zacc = z;
          for (int k = 0; k < 2; ++k)
            for (int i = 0; i < 3; ++i) med[k][i] = 0;
          return;
        }
      }
    }
    const bool sign = r < 0;
    const M av = sign ? ~r : r;
    const Interval<M> iv = ones_count(av, med[C]);
    median_update(med[C], iv.oc);
    int vl;
    const uint64_t vb = value_code(iv.code, iv.width - 1, vl);
    pend.code(bw, iv.oc, vb | ((uint64_t)sign << vl), vl + 1);
  }
};

template <bool MONO, typename M>
__device__ __forceinline__ void scan(const Args& a, int lane, int* ring,
                                     const long long* m0) {
  const int nv = max(min(a.nvals[lane], a.W), 0);
  Coder<M> s{{}, {}, 0, Writer(a.out + (size_t)lane * a.cap, a.cap),
             a.res + lane, (size_t)a.L, nv};
#pragma unroll
  for (int i = 0; i < 6; ++i) s.med[i / 3][i % 3] = (M)m0[i];
  // one staged step is one word
  Stage<true, false> st{ring + threadIdx.x, a.res + lane, nullptr,
                        (size_t)a.L, nv};
  const int ntiles = (nv + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
    const int w1 = min(k * TILE + TILE, nv);
    int w = k * TILE;
    if (MONO) {
      for (; w < w1; ++w) s.template word<0>(*st.at(w), w);
    } else {
      // TILE is even, so a tile never splits a sample's two words
      for (; w + 1 < w1; w += 2) {
        s.template word<0>(*st.at(w), w);
        s.template word<1>(*st.at(w + 1), w + 1);
      }
      if (w < w1) s.template word<0>(*st.at(w), w);
    }
  }
  s.pend.finish(s.bw);
  s.bw.finish();
  a.total[lane] = s.bw.total();
}

template <bool MONO>
__global__ void __launch_bounds__(THREADS) words_kernel(Args a) {
  __shared__ __align__(16) int ring[ring_ints<true, false>()];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.L) return;
  long long m0[6];
  bool wide = false;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    m0[i] = a.med0[lane * 6 + i];
    wide |= m0[i] != (long long)(int)m0[i];
  }
  if (wide) {
    atomicAdd(a.wide, 1);
    scan<MONO, long long>(a, lane, ring, m0);
  } else {
    scan<MONO, int>(a, lane, ring, m0);
  }
}

}  // namespace

// res (W, L) int32 residual words (stereo: channel-interleaved per sample);
// med0 (L, 2, 3) int64 quantized medians; nvals (L,) int32 valid words; out
// (L, cap) uint32 payload rows, zero-filled by the caller; total (L,) int64
// payload bits; wide (1,) int32, zeroed by the caller: gains the lanes
// coded with int64 medians. Returns the launch's CUDA error code.
extern "C" int wvpk_encode_words(const void* res, const void* med0,
                                 const void* nvals, void* out, void* total,
                                 void* wide, int L, int W, int cap, int mono,
                                 void* stream) {
  Args a{(const int*)res, (const long long*)med0, (const int*)nvals,
         (uint32_t*)out,  (long long*)total,      (int*)wide,
         L,               W,                      cap};
  void (*fn)(Args) = mono ? words_kernel<true> : words_kernel<false>;
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      (const void*)fn, dim3((L + THREADS - 1) / THREADS), dim3(THREADS),
      params, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
