// WavPack decorrelation with the post step folded in, for Hopper (sm_90a):
// one thread per lane, generic term chain.
//
// Replaces wvpk/ops/decorr_pallas.py::_decorr_kernel called with
// fold_post. Its plain version is wvpk_torch/ops/decorr.py::decorr_post.
// The wvc arm (plain version decorr.py::decorr_post_wvc) folds
// wvpk/engine/fused.py::fused_decode_wvc's post steps into the same pass:
// given each word's correction it runs the chain on the lossy residuals,
// adds the corrections after the chain and before the joint undo (the
// chain is linear in the residual for its lossy-driven predictions), and
// returns two CRCs: the lossy one, which the wv header checks, with its own
// mute point, and the exact one, which the wvc header checks, with the
// exact samples' mute point.
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

#include "decorr_pass.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

__device__ __forceinline__ int cabs32(int v) {
  return v < 0 ? (int)(0u - (unsigned)v) : v;
}

// Joint-stereo undo and the mute check of one sample (UnpackUtils.cs:
// 609-646); returns whether it is out of range.
template <bool MONO>
__device__ __forceinline__ bool post(int va, int vb, bool jt, int thr,
                                     int& out_l, int& out_r) {
  out_l = va;
  out_r = vb;
  if (MONO) return cabs32(out_l) > thr;
  if (jt) {
    out_r = (int)((unsigned)vb - (unsigned)(va >> 1));
    out_l = add32(va, out_r);
  }
  return cabs32(out_l) > thr || cabs32(out_r) > thr;
}

// The running CRC over one sample, up to the lane's first bad sample.
template <bool MONO>
__device__ __forceinline__ void crc_step(uint32_t& crc, int out_l,
                                         int out_r) {
  crc = MONO ? crc * 3u + (unsigned)out_l
             : crc * 9u + (unsigned)out_l * 3u + (unsigned)out_r;
}

template <bool MONO, bool WVC>
__global__ void __launch_bounds__(THREADS)
decorr_kernel(const int* __restrict__ res, const int* __restrict__ corr,
              const int* __restrict__ terms,
              const int* __restrict__ deltas, const int* __restrict__ wa0,
              const int* __restrict__ wb0, const int* __restrict__ hist_a,
              const int* __restrict__ hist_b,
              const int* __restrict__ num_terms,
              const int* __restrict__ nsamples,
              const int* __restrict__ joint,
              const int* __restrict__ mute_thr, int* __restrict__ out,
              int* __restrict__ crc_out, int* __restrict__ crc_wvc_out,
              int* __restrict__ first_bad, int L, int T) {
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
  // with WVC, crc/fb follow the exact samples and crc_l/fb_l the lossy
  uint32_t crc = 0xFFFFFFFFu, crc_l = 0xFFFFFFFFu;
  int fb = ns_lane, fb_l = ns_lane;

  const size_t row = (size_t)L * C;
  const int* in = res + (size_t)lane * C;
  const int* cin = WVC ? corr + (size_t)lane * C : nullptr;
  int* o = out + (size_t)lane * C;
  for (int t = 0; t < ns; ++t, in += row, o += row) {
    const int m = t & 7;
    int va = in[0];
    int vb = MONO ? 0 : in[1];
    for (int k = 0; k < nt; ++k) {
      if (MONO)
        va = apply_mono(term[k], delta[k], wa[k], ra[k], m, va);
      else
        apply_stereo(term[k], delta[k], wa[k], wb[k], ra[k], rb[k], m, va,
                     vb);
    }

    // folded joint-stereo undo, mute check and CRC
    int out_l, out_r;
    if (WVC) {
      if (post<MONO>(va, vb, jt, thr, out_l, out_r) && fb_l == ns_lane)
        fb_l = t;
      if (t < fb_l) crc_step<MONO>(crc_l, out_l, out_r);
      va = add32(va, cin[0]);
      if (!MONO) vb = add32(vb, cin[1]);
      cin += row;
    }
    if (post<MONO>(va, vb, jt, thr, out_l, out_r) && fb == ns_lane) fb = t;
    if (t < fb) crc_step<MONO>(crc, out_l, out_r);
    o[0] = out_l;
    if (!MONO) o[1] = out_r;
  }
  for (int t = ns; t < T; ++t, o += row) {
    o[0] = 0;
    if (!MONO) o[1] = 0;
  }
  if (WVC) {
    crc_out[lane] = (int)crc_l;
    crc_wvc_out[lane] = (int)crc;
  } else {
    crc_out[lane] = (int)crc;
  }
  first_bad[lane] = fb;
}

}  // namespace

// res, corr and out (T, L, C) int32, corr only with `wvc` (else null);
// terms, deltas, wa0, wb0 (L, 16) and hist_a/hist_b (L, 16, 8) int32;
// num_terms, nsamples, joint, mute_thr (L,) int32; crc, first_bad and,
// with `wvc`, crc_wvc (L,) int32. Without wvc, crc covers the output; with
// it, crc the lossy samples and crc_wvc the exact ones, and first_bad is the
// exact samples'. Returns the launch's CUDA error code.
extern "C" int wvpk_decorr_post(const void* res, const void* corr,
                                const void* terms, const void* deltas,
                                const void* wa0, const void* wb0,
                                const void* hist_a, const void* hist_b,
                                const void* num_terms, const void* nsamples,
                                const void* joint, const void* mute_thr,
                                void* out, void* crc, void* crc_wvc,
                                void* first_bad, int L, int T, int mono,
                                int wvc, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define WVPK_DECORR_ARGS                                                     \
  (const int*)res, (const int*)corr, (const int*)terms, (const int*)deltas, \
      (const int*)wa0, (const int*)wb0, (const int*)hist_a,                 \
      (const int*)hist_b, (const int*)num_terms, (const int*)nsamples,      \
      (const int*)joint, (const int*)mute_thr, (int*)out, (int*)crc,        \
      (int*)crc_wvc, (int*)first_bad, L, T
  if (mono && wvc)
    decorr_kernel<true, true><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
  else if (mono)
    decorr_kernel<true, false><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
  else if (wvc)
    decorr_kernel<false, true><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
  else
    decorr_kernel<false, false><<<grid, block, 0, s>>>(WVPK_DECORR_ARGS);
#undef WVPK_DECORR_ARGS
  return (int)cudaGetLastError();
}
