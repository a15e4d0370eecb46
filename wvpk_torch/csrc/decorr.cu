// WavPack decorrelation with the post step folded in, for Hopper (sm_90a):
// one thread per lane, generic term chain.
//
// Replaces wvpk/ops/decorr_pallas.py::_decorr_kernel called with
// fold_post. Its plain version is wvpk_torch/ops/decorr.py::decorr_post.
// Per sample, the lane's chain of up to 16 passes runs in order
// (UnpackUtils.cs:688-1240): the predictor is (w * sam + 512) >> 10 in 64
// bits truncated to int32; weights move by +/-delta on sign agreement,
// clamped to +/-1024 for the cross-channel terms -1, -2, -3; each pass keeps
// an 8-deep history ring per channel. Then, as fold_post does, the
// joint-stereo undo, the mute check and the running CRC (crc = 3 crc + x,
// a stereo pair 9 crc + 3 l + r) fold into the same sample loop
// (UnpackUtils.cs:609-646).
//
// What bounds it: a lane's samples form a serial recurrence through the
// weights and rings, so the parallelism is the lane count; a bucket of the
// bench corpus has ~8,400 lanes, ~two warps per SM on 132 SMs. The kernel
// is bound by the latency of each thread's dependent integer operations
// and its local-memory traffic, not by device-memory bandwidth (it reads
// and writes 8 bytes per stereo sample).
//
// Design: weights (16 x 2) and rings (16 x 2 x 8) sit in per-thread arrays,
// which the compiler keeps in local memory (L1-cached) because the pass
// and ring-slot indices are dynamic. The 64-bit product replaces the
// Pallas kernel's 16-bit-limb emulation; int32 wrapping adds run in
// unsigned arithmetic. Terms mostly agree across the lanes of a warp (one
// encoder preset per file), so branching on the term class costs little
// divergence. Samples in (T, L, C) layout make a warp's loads and stores
// at one sample index contiguous. Past a lane's sample count the output is
// zero; the caller masks muted lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_NTERMS = 16;
constexpr int MAX_TERM = 8;
constexpr int THREADS = 32;

__device__ __forceinline__ int add32(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int pred(int w, int sam) {
  return (int)(((long long)w * sam + 512) >> 10);
}

__device__ __forceinline__ int upd(int w, int delta, int sam, int v) {
  if (sam != 0 && v != 0) w += (sam ^ v) < 0 ? -delta : delta;
  return w;
}

__device__ __forceinline__ int upd_clamp(int w, int delta, int sam, int v) {
  if (sam != 0 && v != 0)
    w = (sam ^ v) < 0 ? max(w - delta, -1024) : min(w + delta, 1024);
  return w;
}

__device__ __forceinline__ int sam17(const int* r) {
  return (int)(2u * (unsigned)r[0] - (unsigned)r[1]);
}

__device__ __forceinline__ int sam18(const int* r) {
  return ((int)(3u * (unsigned)r[0] - (unsigned)r[1])) >> 1;
}

__device__ __forceinline__ int cabs32(int v) {
  return v < 0 ? (int)(0u - (unsigned)v) : v;
}

template <bool MONO>
__global__ void __launch_bounds__(THREADS)
decorr_kernel(const int* __restrict__ res, const int* __restrict__ terms,
              const int* __restrict__ deltas, const int* __restrict__ wa0,
              const int* __restrict__ wb0, const int* __restrict__ hist_a,
              const int* __restrict__ hist_b,
              const int* __restrict__ num_terms,
              const int* __restrict__ nsamples,
              const int* __restrict__ joint,
              const int* __restrict__ mute_thr, int* __restrict__ out,
              int* __restrict__ crc_out, int* __restrict__ first_bad, int L,
              int T) {
  constexpr int C = MONO ? 1 : 2;
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
  const int ns_lane = nsamples[lane];
  const int ns = min(ns_lane, T);
  const bool jt = joint[lane] != 0;
  const int thr = mute_thr[lane];
  uint32_t crc = 0xFFFFFFFFu;
  int fb = ns_lane;

  const size_t row = (size_t)L * C;
  const int* in = res + (size_t)lane * C;
  int* o = out + (size_t)lane * C;
  for (int t = 0; t < ns; ++t, in += row, o += row) {
    const int m = t & 7;
    int va = in[0];
    int vb = MONO ? 0 : in[1];
    for (int k = 0; k < nt; ++k) {
      const int tv = term[k], d = delta[k];
      int* A = ra[k];
      if (MONO) {
        int sa;
        if (tv >= 1 && tv <= MAX_TERM) sa = A[m];
        else if (tv == 17) sa = sam17(A);
        else if (tv == 18) sa = sam18(A);
        else sa = A[0];
        int oa = add32(pred(wa[k], sa), va);
        wa[k] = upd(wa[k], d, sa, va);
        if (tv >= 1 && tv <= MAX_TERM) {
          A[(m + tv) & 7] = oa;
        } else if (tv == 17 || tv == 18) {
          A[1] = A[0];
          A[0] = oa;
        }
        va = oa;
        continue;
      }
      int* B = rb[k];
      int oa, ob;
      if (tv >= 1 && tv <= MAX_TERM) {
        int sa = A[m], sb = B[m];
        oa = add32(pred(wa[k], sa), va);
        ob = add32(pred(wb[k], sb), vb);
        wa[k] = upd(wa[k], d, sa, va);
        wb[k] = upd(wb[k], d, sb, vb);
        A[(m + tv) & 7] = oa;
        B[(m + tv) & 7] = ob;
      } else if (tv == 17 || tv == 18) {
        int sa = tv == 17 ? sam17(A) : sam18(A);
        int sb = tv == 17 ? sam17(B) : sam18(B);
        oa = add32(pred(wa[k], sa), va);
        ob = add32(pred(wb[k], sb), vb);
        wa[k] = upd(wa[k], d, sa, va);
        wb[k] = upd(wb[k], d, sb, vb);
        A[1] = A[0];
        A[0] = oa;
        B[1] = B[0];
        B[0] = ob;
      } else if (tv == -1) {            // A first, its output feeds B
        int sa = A[0];
        oa = add32(pred(wa[k], sa), va);
        ob = add32(pred(wb[k], oa), vb);
        wa[k] = upd_clamp(wa[k], d, sa, va);
        wb[k] = upd_clamp(wb[k], d, oa, vb);
        A[0] = ob;
      } else if (tv == -2) {            // B first, its output feeds A
        int sb = B[0];
        ob = add32(pred(wb[k], sb), vb);
        oa = add32(pred(wa[k], ob), va);
        wa[k] = upd_clamp(wa[k], d, ob, va);
        wb[k] = upd_clamp(wb[k], d, sb, vb);
        B[0] = oa;
      } else if (tv == -3) {
        int sa = A[0], sb = B[0];
        oa = add32(pred(wa[k], sa), va);
        ob = add32(pred(wb[k], sb), vb);
        wa[k] = upd_clamp(wa[k], d, sa, va);
        wb[k] = upd_clamp(wb[k], d, sb, vb);
        A[0] = ob;
        B[0] = oa;
      } else {  // no valid term class: predicts from slot 0, ring unchanged
        int sa = A[0], sb = B[0];
        oa = add32(pred(wa[k], sa), va);
        ob = add32(pred(wb[k], sb), vb);
        wa[k] = upd(wa[k], d, sa, va);
        wb[k] = upd(wb[k], d, sb, vb);
      }
      va = oa;
      vb = ob;
    }

    // folded joint-stereo undo, mute check and CRC
    int out_l = va, out_r = vb;
    bool bad;
    if (MONO) {
      bad = cabs32(out_l) > thr;
    } else {
      if (jt) {
        out_r = (int)((unsigned)vb - (unsigned)(va >> 1));
        out_l = add32(va, out_r);
      }
      bad = cabs32(out_l) > thr || cabs32(out_r) > thr;
    }
    if (bad && fb == ns_lane) fb = t;
    if (t < fb)
      crc = MONO ? crc * 3u + (unsigned)out_l
                 : crc * 9u + (unsigned)out_l * 3u + (unsigned)out_r;
    o[0] = out_l;
    if (!MONO) o[1] = out_r;
  }
  for (int t = ns; t < T; ++t, o += row) {
    o[0] = 0;
    if (!MONO) o[1] = 0;
  }
  crc_out[lane] = (int)crc;
  first_bad[lane] = fb;
}

}  // namespace

extern "C" int wvpk_decorr_post(const void* res, const void* terms,
                                const void* deltas, const void* wa0,
                                const void* wb0, const void* hist_a,
                                const void* hist_b, const void* num_terms,
                                const void* nsamples, const void* joint,
                                const void* mute_thr, void* out, void* crc,
                                void* first_bad, int L, int T, int mono,
                                void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define WVPK_DECORR_ARGS                                                     \
  (const int*)res, (const int*)terms, (const int*)deltas, (const int*)wa0,  \
      (const int*)wb0, (const int*)hist_a, (const int*)hist_b,              \
      (const int*)num_terms, (const int*)nsamples, (const int*)joint,       \
      (const int*)mute_thr, (int*)out, (int*)crc, (int*)first_bad, L, T
  if (mono)
    decorr_kernel<true><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
  else
    decorr_kernel<false><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
#undef WVPK_DECORR_ARGS
  return (int)cudaGetLastError();
}
