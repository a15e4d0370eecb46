// Fused hybrid (lossy) encode for Hopper (sm_90a): one thread per lane;
// one kernel compiled for each term chain of a table, and a run-time
// kernel for any chain; each writes its lane's payload bits straight into
// its row.
//
// Replaces wvpk/ops/encode_pallas.py::_hybrid_kernel
// (hybrid_encode_pallas) and its static_terms unroll. Its plain version is
// wvpk_torch/ops/encode_pack.py::pack_segments_device over
// ops/encode_kernels.py::hybrid_encode_scan (the payload with the final
// flush, and the reconstruction). Per sample: peel the lane's passes off
// the targets (csrc/decorr_pass.cuh); code each residual word under the
// error limit (update_error_limit before channel-A words,
// WordsUtils.cs:195-261, then the decoder's binary search run in the
// encode direction: while high - low exceeds the limit, at most 32 steps,
// halve the interval toward the value and write the comparison bit); then
// apply the decode chain over the residuals the decoder will reconstruct,
// so the carried state follows the lossy decode, and write that
// reconstruction (the CRC covers it). Where the decoder would read a
// zero-run length, the scan writes gamma(0), one 0 bit, and codes the
// word: hybrid blocks never start runs, as in wvpk's device encoder.
//
// What bounds it: a lane is one serial chain through the decorrelation
// state, the entropy state and its bit cursor; the parallelism is the lane
// count (~8,300 lanes, about two warps per SM). Per sample: two passes
// over the term chain and two words, each with the error limit, the search
// and the slow level's log. Device memory moves 8 bytes in and 8 out per
// stereo sample plus the payload: ~0.2 ms.
//
// Design:
// - One kernel for each chain of WVPK_CHAIN_TABLE (decorr_pass.cuh;
//   ops/decorr_cuda.py::CHAINS) and profile (mono, HYBRID_BITRATE,
//   HYBRID_BALANCE): the chain's terms are template arguments of its
//   ChainState, so the weights and the 8-deep rings are registers (ptxas:
//   no stack frame). Within a step the peel and the apply switch on the
//   ring slot m = t & 7, each case with m a constant (every pass and ring
//   index is then one), and the word coder between them is compiled once
//   per channel, not once per slot.
// - The run-time kernel (GenericState: the chain read from per-thread
//   arrays in local memory) serves every other chain and calls without
//   `static_terms`.
// - The word coder of encode_bits.cuh: 32-bit medians, intervals and
//   codes for lanes whose medians fit int32 (int64 medians in the same
//   kernel for any other lane, counted in `wide`); no 64-bit division;
//   selects for the median update, the value code and the holding
//   transitions.
// - The search runs on the interval relative to its low end, in 32 bits
//   (its width is below 2^27; an error limit outside [-1, 2^31 - 1]
//   compares as its clamp); the reconstruction low + mid and the slow
//   level's mylog2 stay int64, as do the bitrate accumulators and the
//   error limit (csrc/hybrid.cuh, shared with the entropy decoder).
// - The targets are staged ahead (stage.cuh): each thread copies its
//   lane's next 32 samples into a double-buffered ring in shared memory
//   with cp.async while it codes the current 32.
// - The log2/exp2 tables sit in shared memory, as in the entropy decode
//   kernel.
// Samples in (T, L, C) layout make a warp's loads and stores at one sample
// index contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "decorr_pass.cuh"
#include "encode_bits.cuh"
#include "hybrid.cuh"
#include "stage.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;
static_assert(THREADS == STAGE_LANES, "one staging column a thread");

struct Args {
  const int *targ, *terms, *deltas, *wa0, *wb0, *hist_a, *hist_b, *num_terms;
  const long long *med0, *slow0, *acc0, *delta0;
  const int *nvals, *tables;
  uint32_t* out;
  long long* total;
  int* recon;
  int* wide;
  int L, T, cap;
};

// The error limit as the search compares it with an interval's width d:
// an int body's d lies in [0, 2^27), where a limit below -1 acts as -1 and
// one above 2^31 - 1 as that.
__device__ __forceinline__ int search_limit(long long err, int) {
  return (int)(err < -1 ? -1 : err > 0x7FFFFFFF ? 0x7FFFFFFF : err);
}
__device__ __forceinline__ long long search_limit(long long err, long long) {
  return err;
}

// The search in the encode direction over [0, d], the value's code y in
// it, relative to the interval's low end: while hi - lo exceeds the limit
// (at most 32 steps) the midpoint mid = (hi + lo + 1) >> 1 splits it, the
// comparison bit goes out (LSB first) and the half holding y is kept.
// Returns the bits, their count and the last midpoint, which the decoder
// reconstructs. The reference runs it on the absolute interval; shifted by
// its low end, every midpoint and comparison is the same.
template <typename M>
__device__ __forceinline__ M search(M y, M d, long long err, uint64_t& bits,
                                    int& nb) {
  const M e = search_limit(err, M{});
  M lo = 0, hi = d, mid = (hi + lo + 1) >> 1;
  uint32_t b = 0;
  int n = 0;
  while (n < 32 && hi - lo > e) {
    if (y >= mid) {
      lo = mid;
      b |= 1u << n;
    } else {
      hi = mid - 1;
    }
    mid = (hi + lo + 1) >> 1;
    ++n;
  }
  bits = b;
  nb = n;
  return mid;
}

template <typename M>
struct HybridLane {
  M med[2][3];
  long long slow[2], acc[2], delta[2], err[2];
  Pending<Count<M>> pend;
};

// One residual word of channel E (valid: within the lane's words); returns
// the residual the decoder reconstructs from the bits written.
template <int E, bool MONO, bool BITRATE, bool BALANCE, typename M>
__device__ __forceinline__ int hybrid_word(HybridLane<M>& s, int r,
                                           Writer& bw, const int* log2t,
                                           const int* exp2t) {
  // the run gate's gamma(0), written ahead of the word
  const int gate = !s.pend.valid && (s.med[0][0] & ~(M)1) == 0 &&
                   (s.med[1][0] & ~(M)1) == 0;
  const bool sign = r < 0;
  const M av = sign ? ~r : r;
  M* m = s.med[E];
  const Interval<M> iv = ones_count(av, m);
  if (E == 0)
    update_error_limit<MONO, BITRATE, BALANCE>(s.slow, s.acc, s.delta, s.err,
                                               exp2t);
  const long long err = s.err[E];
  median_update(m, iv.oc);

  uint64_t bits;
  int nb;
  M mid;
  if (err == 0) {                        // limit 0: the lossless code
    bits = value_code(iv.code, iv.width - 1, nb);
    mid = iv.code;
  } else {
    mid = search(iv.code, iv.width - 1, err, bits, nb);
  }
  const long long v = (long long)(av - iv.code) + mid;  // low + mid
  if (BITRATE) s.slow[E] = slow_decay(s.slow[E]) + mylog2(v, log2t);
  s.pend.code(bw, iv.oc, bits | ((uint64_t)sign << nb), nb + 1, gate);
  return (int)(uint32_t)(sign ? ~v : v);
}

// Ring slot m as a constant: the peel and the apply of the chain for each
// case of t & 7. A chain read at run time indexes its rings at run time
// anyway, and takes them directly (eight copies of its loops only grow
// the code).
template <class Chain>
__device__ __forceinline__ void peel_at(const Chain& ch, int m, int& va,
                                        int& vb) {
  switch (m) {
    case 0: ch.peel(0, va, vb); break;
    case 1: ch.peel(1, va, vb); break;
    case 2: ch.peel(2, va, vb); break;
    case 3: ch.peel(3, va, vb); break;
    case 4: ch.peel(4, va, vb); break;
    case 5: ch.peel(5, va, vb); break;
    case 6: ch.peel(6, va, vb); break;
    default: ch.peel(7, va, vb); break;
  }
}

template <class Chain>
__device__ __forceinline__ void apply_at(Chain& ch, int m, int& va,
                                         int& vb) {
  switch (m) {
    case 0: ch.apply(0, va, vb); break;
    case 1: ch.apply(1, va, vb); break;
    case 2: ch.apply(2, va, vb); break;
    case 3: ch.apply(3, va, vb); break;
    case 4: ch.apply(4, va, vb); break;
    case 5: ch.apply(5, va, vb); break;
    case 6: ch.apply(6, va, vb); break;
    default: ch.apply(7, va, vb); break;
  }
}

template <bool MONO>
__device__ __forceinline__ void peel_at(const GenericState<MONO>& ch, int m,
                                        int& va, int& vb) {
  ch.peel(m, va, vb);
}

template <bool MONO>
__device__ __forceinline__ void apply_at(GenericState<MONO>& ch, int m,
                                         int& va, int& vb) {
  ch.apply(m, va, vb);
}

// A lane's whole scan with medians of type M.
template <bool MONO, bool BITRATE, bool BALANCE, typename M, class Chain>
__device__ __forceinline__ void scan(const Args& a, int lane, int* ring,
                                     const int* tab, Chain& ch,
                                     const long long* m0) {
  constexpr int C = MONO ? 1 : 2;
  const int* log2t = tab;
  const int* exp2t = tab + TABLE;
  HybridLane<M> s;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int i = 0; i < 3; ++i) s.med[c][i] = (M)m0[c * 3 + i];
    s.slow[c] = a.slow0[lane * 2 + c];
    s.acc[c] = a.acc0[lane * 2 + c];
    s.delta[c] = a.delta0[lane * 2 + c];
    s.err[c] = 0;
  }
  const int nv = a.nvals[lane];
  Writer bw(a.out + (size_t)lane * a.cap, a.cap);

  const size_t row = (size_t)a.L * C;
  Stage<MONO, false> st{ring + threadIdx.x * C, a.targ + (size_t)lane * C,
                        nullptr, row, a.T};
  int* o = a.recon + (size_t)lane * C;
  const int ntiles = (a.T + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
    const int t1 = min(k * TILE + TILE, a.T);
    for (int t = k * TILE; t < t1; ++t) {
      const int m = t & 7;
      const int* in = st.at(t);
      int va = in[0];
      int vb = MONO ? 0 : in[1];
      peel_at(ch, m, va, vb);
      va = t * C < nv ? hybrid_word<0, MONO, BITRATE, BALANCE>(
                            s, va, bw, log2t, exp2t)
                      : 0;
      if (!MONO)
        vb = t * C + 1 < nv ? hybrid_word<1, MONO, BITRATE, BALANCE>(
                                  s, vb, bw, log2t, exp2t)
                            : 0;
      apply_at(ch, m, va, vb);
      int* op = o + (size_t)t * row;
      op[0] = va;
      if (!MONO) op[1] = vb;
    }
  }
  s.pend.finish(bw);
  bw.finish();
  a.total[lane] = bw.total();
}

// The block's tables and staging ring, the lane's chain state, then the
// scan in the body its medians need.
template <bool MONO, bool BITRATE, bool BALANCE, class Chain>
__device__ __forceinline__ void run(const Args& a, int* tab, int* ring) {
  for (int i = threadIdx.x; i < 2 * TABLE; i += blockDim.x)
    tab[i] = a.tables[i];
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.L) return;
  Chain ch;
  ch.load(a, lane);
  long long m0[6];
  bool wide = false;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    m0[i] = a.med0[lane * 6 + i];
    wide |= m0[i] != (long long)(int)m0[i];
  }
  if (wide) {
    atomicAdd(a.wide, 1);
    scan<MONO, BITRATE, BALANCE, long long>(a, lane, ring, tab, ch, m0);
  } else {
    scan<MONO, BITRATE, BALANCE, int>(a, lane, ring, tab, ch, m0);
  }
}

template <bool MONO, bool BITRATE, bool BALANCE, int... TV>
__global__ void __launch_bounds__(THREADS) hybrid_chain(Args a) {
  __shared__ int tab[2 * TABLE];
  __shared__ __align__(16) int ring[ring_ints<MONO, false>()];
  run<MONO, BITRATE, BALANCE, ChainState<MONO, TV...>>(a, tab, ring);
}

template <bool MONO, bool BITRATE, bool BALANCE>
__global__ void __launch_bounds__(THREADS) hybrid_generic(Args a) {
  __shared__ int tab[2 * TABLE];
  __shared__ __align__(16) int ring[ring_ints<MONO, false>()];
  run<MONO, BITRATE, BALANCE, GenericState<MONO>>(a, tab, ring);
}

using Kernel = void (*)(Args);

// A chain of WVPK_CHAIN_TABLE by its id.
#define WVPK_CHAIN(ID, MONO_, ...)                                  \
  case ID:                                                          \
    if constexpr (MONO_ == MONO)                                    \
      return hybrid_chain<MONO, BITRATE, BALANCE, __VA_ARGS__>;     \
    break;

// The kernel compiled for chain `id`, else (an id of the other channel
// count too) the run-time one.
template <bool MONO, bool BITRATE, bool BALANCE>
Kernel kernel_for(int id) {
  switch (id) {
    WVPK_CHAIN_TABLE
    default:
      break;
  }
  return hybrid_generic<MONO, BITRATE, BALANCE>;
}

#undef WVPK_CHAIN

template <bool MONO>
Kernel profile_kernel(bool bitrate, bool balance, int chain) {
  if (!bitrate) return kernel_for<MONO, false, false>(chain);
  if (!balance || MONO)  // balance acts on true stereo only
    return kernel_for<MONO, true, false>(chain);
  return kernel_for<MONO, true, true>(chain);
}

}  // namespace

// targ and recon (T, L, C) int32; terms, deltas, wa0, wb0 (L, 16) and
// hist_a/hist_b (L, 16, 8) int32 (mono: the b arrays unread); num_terms,
// nvals (L,) int32; med0 (L, 2, 3), slow0/acc0/delta0 (L, 2) int64; tables:
// log2 then exp2, 256 int32 each; out (L, cap) uint32 payload rows,
// zero-filled by the caller; total (L,) int64 payload bits; wide (1,)
// int32, zeroed by the caller: gains the lanes coded with int64 medians.
// `chain`: the id of the chain every lane carries (ops/decorr_cuda.py::
// CHAINS), or -1 (or an id outside the table) for the run-time kernel,
// whose lanes may carry any chain. Returns the launch's CUDA error code.
extern "C" int wvpk_encode_hybrid(
    const void* targ, const void* terms, const void* deltas, const void* wa0,
    const void* wb0, const void* hist_a, const void* hist_b,
    const void* num_terms, const void* med0, const void* slow0,
    const void* acc0, const void* delta0, const void* nvals,
    const void* tables, void* out, void* total, void* recon, void* wide,
    int L, int T, int cap, int mono, int bitrate, int balance, int chain,
    void* stream) {
  Args a{(const int*)targ,       (const int*)terms,
         (const int*)deltas,     (const int*)wa0,
         (const int*)wb0,        (const int*)hist_a,
         (const int*)hist_b,     (const int*)num_terms,
         (const long long*)med0, (const long long*)slow0,
         (const long long*)acc0, (const long long*)delta0,
         (const int*)nvals,      (const int*)tables,
         (uint32_t*)out,         (long long*)total,
         (int*)recon,            (int*)wide,
         L,                      T,
         cap};
  const Kernel fn = mono ? profile_kernel<true>(bitrate, balance, chain)
                         : profile_kernel<false>(bitrate, balance, chain);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      (const void*)fn, dim3((L + THREADS - 1) / THREADS), dim3(THREADS),
      params, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
