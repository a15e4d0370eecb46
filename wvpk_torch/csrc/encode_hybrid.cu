// Fused hybrid (lossy) encode for Hopper (sm_90a): one thread per lane,
// any term chain, writing the lane's payload bits straight into its row.
//
// Replaces wvpk/ops/encode_pallas.py::_hybrid_kernel
// (hybrid_encode_pallas). Its plain version is wvpk_torch/ops/
// encode_pack.py::pack_segments_device over ops/encode_kernels.py::
// hybrid_encode_scan (the payload with the final flush, and the
// reconstruction). Per sample: peel the lane's passes off the targets
// (csrc/decorr_pass.cuh); code each residual word under the error limit
// (update_error_limit before channel-A words, WordsUtils.cs:195-261, then
// the decoder's binary search run in the encode direction: while
// high - low exceeds the limit, at most 32 steps, halve the interval toward
// the value and write the comparison bit); then apply the decode chain over
// the residuals the decoder will reconstruct, so the carried state follows
// the lossy decode, and write that reconstruction (the CRC covers it).
// Where the decoder would read a zero-run length, the scan writes gamma(0),
// one 0 bit, and codes the word: hybrid blocks never start runs, as in
// wvpk's device encoder.
//
// What bounds it: a lane is one serial chain through the decorrelation
// state, the entropy state and its bit cursor; the parallelism is the lane
// count. Per sample: two passes over the term chain, two words, each with
// a 64-bit division and up to 32 search steps. Device memory moves 8 bytes
// in and 8 out per stereo sample plus the payload.
//
// Design: the bitrate accumulators are int64 (the Pallas kernel splits them
// into 16-bit halves), the log2/exp2 tables sit in shared memory as in the
// entropy decode kernel (csrc/hybrid.cuh is shared with it), the division
// is native and the search is a loop that stops with the interval, not 32
// unrolled selects. The profile (mono, HYBRID_BITRATE, HYBRID_BALANCE) is a
// template.

#include <cstdint>
#include <cuda_runtime.h>

#include "decorr_pass.cuh"
#include "encode_bits.cuh"
#include "hybrid.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

struct HybridLane {
  long long med[2][3];
  long long slow[2], acc[2], delta[2], err[2];
  Pending pend;
};

// One residual word of channel E (valid: within the lane's words); returns
// the residual the decoder reconstructs from the bits written.
template <int E, bool MONO, bool BITRATE, bool BALANCE>
__device__ __forceinline__ long long hybrid_word(HybridLane& s, long long r,
                                                 Writer& bw,
                                                 const int* log2t,
                                                 const int* exp2t) {
  if (s.pend.clear && (s.med[0][0] & ~1LL) == 0 &&
      (s.med[1][0] & ~1LL) == 0)
    bw.put(0, 1);                        // the run gate's gamma(0)
  const bool sign = r < 0;
  const long long av = sign ? ~r : r;
  long long* m = s.med[E];
  long long low, high;
  const long long oc = ones_count(av, m, low, high);
  if (E == 0)
    update_error_limit<MONO, BITRATE, BALANCE>(s.slow, s.acc, s.delta, s.err,
                                               exp2t);
  const long long err = s.err[E];
  median_update(m, oc);

  uint64_t bits;
  int nb;
  long long mid;
  if (err == 0) {                        // limit 0: the lossless code
    bits = value_code(av, low, high, nb);
    mid = av;
  } else {
    long long lo = low, hi = high;
    mid = (hi + lo + 1) >> 1;
    bits = 0;
    nb = 0;
    while (nb < 32 && hi - lo > err) {
      if (av >= mid) {
        lo = mid;
        bits |= 1ull << nb;
      } else {
        hi = mid - 1;
      }
      mid = (hi + lo + 1) >> 1;
      ++nb;
    }
  }
  if (BITRATE) s.slow[E] = slow_decay(s.slow[E]) + mylog2(mid, log2t);
  s.pend.code(bw, oc, bits | ((uint64_t)sign << nb), nb + 1);
  return wrap32(sign ? ~mid : mid);
}

template <bool MONO, bool BITRATE, bool BALANCE>
__global__ void __launch_bounds__(THREADS)
hybrid_kernel(const int* __restrict__ targ, const int* __restrict__ terms,
              const int* __restrict__ deltas, const int* __restrict__ wa0,
              const int* __restrict__ wb0, const int* __restrict__ hist_a,
              const int* __restrict__ hist_b,
              const int* __restrict__ num_terms,
              const long long* __restrict__ med0,
              const long long* __restrict__ slow0,
              const long long* __restrict__ acc0,
              const long long* __restrict__ delta0,
              const int* __restrict__ nvals, const int* __restrict__ tables,
              uint32_t* __restrict__ out, long long* __restrict__ total,
              int* __restrict__ recon, int L, int T, int cap) {
  constexpr int C = MONO ? 1 : 2;
  __shared__ int tab[2 * TABLE];
  for (int i = threadIdx.x; i < 2 * TABLE; i += blockDim.x)
    tab[i] = tables[i];
  __syncthreads();
  const int* log2t = tab;
  const int* exp2t = tab + TABLE;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  int nt = min(max(num_terms[lane], 0), MAX_NTERMS);
  int term[MAX_NTERMS], delta[MAX_NTERMS], wa[MAX_NTERMS], wb[MAX_NTERMS];
  int ra[MAX_NTERMS][8], rb[MAX_NTERMS][8];
  for (int k = 0; k < nt; ++k) {
    int i = lane * MAX_NTERMS + k;
    term[k] = terms[i];
    delta[k] = deltas[i];
    wa[k] = wa0[i];
    wb[k] = MONO ? 0 : wb0[i];
    for (int j = 0; j < 8; ++j) {
      ra[k][j] = hist_a[i * 8 + j];
      rb[k][j] = MONO ? 0 : hist_b[i * 8 + j];
    }
  }
  HybridLane s;
  for (int c = 0; c < 2; ++c) {
    for (int i = 0; i < 3; ++i) s.med[c][i] = med0[lane * 6 + c * 3 + i];
    s.slow[c] = slow0[lane * 2 + c];
    s.acc[c] = acc0[lane * 2 + c];
    s.delta[c] = delta0[lane * 2 + c];
    s.err[c] = 0;
  }
  const int nv = nvals[lane];
  Writer bw(out + (size_t)lane * cap, cap);

  const size_t row = (size_t)L * C;
  const int* in = targ + (size_t)lane * C;
  int* o = recon + (size_t)lane * C;
  for (int t = 0; t < T; ++t, in += row, o += row) {
    const int m = t & 7;
    int va = in[0];
    int vb = MONO ? 0 : in[1];
    for (int k = nt - 1; k >= 0; --k) {
      if (MONO)
        va = peel_mono(term[k], wa[k], ra[k], m, va);
      else
        peel_stereo(term[k], wa[k], wb[k], ra[k], rb[k], m, va, vb);
    }
    va = t * C < nv ? (int)hybrid_word<0, MONO, BITRATE, BALANCE>(
                          s, va, bw, log2t, exp2t)
                    : 0;
    if (!MONO)
      vb = t * C + 1 < nv ? (int)hybrid_word<1, MONO, BITRATE, BALANCE>(
                                s, vb, bw, log2t, exp2t)
                          : 0;
    for (int k = 0; k < nt; ++k) {
      if (MONO)
        va = apply_mono(term[k], delta[k], wa[k], ra[k], m, va);
      else
        apply_stereo(term[k], delta[k], wa[k], wb[k], ra[k], rb[k], m, va,
                     vb);
    }
    o[0] = va;
    if (!MONO) o[1] = vb;
  }
  s.pend.finish(bw);
  bw.finish();
  total[lane] = bw.total;
}

struct Args {
  const int *targ, *terms, *deltas, *wa0, *wb0, *hist_a, *hist_b, *num_terms;
  const long long *med0, *slow0, *acc0, *delta0;
  const int *nvals, *tables;
  uint32_t* out;
  long long* total;
  int* recon;
  int L, T, cap;
};

template <bool MONO, bool BITRATE, bool BALANCE>
void launch(const Args& a, cudaStream_t s) {
  dim3 grid((a.L + THREADS - 1) / THREADS), block(THREADS);
  hybrid_kernel<MONO, BITRATE, BALANCE><<<grid, block, 0, s>>>(
      a.targ, a.terms, a.deltas, a.wa0, a.wb0, a.hist_a, a.hist_b,
      a.num_terms, a.med0, a.slow0, a.acc0, a.delta0, a.nvals, a.tables,
      a.out, a.total, a.recon, a.L, a.T, a.cap);
}

template <bool MONO>
void launch_profile(const Args& a, bool bitrate, bool balance,
                    cudaStream_t s) {
  if (!bitrate)
    launch<MONO, false, false>(a, s);
  else if (!balance || MONO)  // balance acts on true stereo only
    launch<MONO, true, false>(a, s);
  else
    launch<MONO, true, true>(a, s);
}

}  // namespace

// targ and recon (T, L, C) int32; terms, deltas, wa0, wb0 (L, 16) and
// hist_a/hist_b (L, 16, 8) int32 (mono: the b arrays unread); num_terms,
// nvals (L,) int32; med0 (L, 2, 3), slow0/acc0/delta0 (L, 2) int64; tables:
// log2 then exp2, 256 int32 each; out (L, cap) uint32 payload rows,
// zero-filled by the caller; total (L,) int64 payload bits. Returns the
// launch's CUDA error code.
extern "C" int wvpk_encode_hybrid(
    const void* targ, const void* terms, const void* deltas, const void* wa0,
    const void* wb0, const void* hist_a, const void* hist_b,
    const void* num_terms, const void* med0, const void* slow0,
    const void* acc0, const void* delta0, const void* nvals,
    const void* tables, void* out, void* total, void* recon, int L, int T,
    int cap, int mono, int bitrate, int balance, void* stream) {
  Args a{(const int*)targ,       (const int*)terms,
         (const int*)deltas,     (const int*)wa0,
         (const int*)wb0,        (const int*)hist_a,
         (const int*)hist_b,     (const int*)num_terms,
         (const long long*)med0, (const long long*)slow0,
         (const long long*)acc0, (const long long*)delta0,
         (const int*)nvals,      (const int*)tables,
         (uint32_t*)out,         (long long*)total,
         (int*)recon,            L,
         T,                      cap};
  cudaStream_t s = (cudaStream_t)stream;
  if (mono)
    launch_profile<true>(a, bitrate, balance, s);
  else
    launch_profile<false>(a, bitrate, balance, s);
  return (int)cudaGetLastError();
}
