// Decorrelation inversion for the device encoder, for Hopper (sm_90a): one
// thread per lane, any term chain.
//
// Replaces wvpk/ops/encode_pallas.py::_invert_kernel (decorr_invert_pallas).
// Its plain version is wvpk_torch/ops/encode_kernels.py::
// decorr_invert_warm, with the same arguments and results. Per sample the
// lane's passes are peeled off the target values last pass first (each
// subtracts its prediction; the cross terms -1/-2 read the partner's value
// before this pass's peel), which gives the residuals the entropy coder
// codes; then the decode chain runs forward over those residuals, so the
// weights and rings advance exactly as the decoder's will. Both halves are
// csrc/decorr_pass.cuh, the decode kernel's pass body. With STATE the
// kernel also writes the final weights and rings (the warm seeding scan);
// slots past the lane's chain keep their seeds.
//
// What bounds it: a lane's samples form a serial recurrence through the
// weights and rings, so the parallelism is the lane count (a 768 s track at
// 4,096-sample blocks is ~8,300 lanes: two warps per SM). Each sample costs
// two passes over the chain of dependent integer operations on state in
// local memory; device memory moves 8 bytes in and 8 out per stereo sample.
//
// Design: the Pallas kernel unrolls one static chain per compile; here each
// lane reads its chain at run time (terms mostly agree across a warp, so the
// branch on the term class diverges little), which also covers mono chains
// with cross terms. Samples in (T, L, C) layout make a warp's loads and
// stores at one sample index contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "decorr_pass.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;

template <bool MONO, bool STATE>
__global__ void __launch_bounds__(THREADS)
invert_kernel(const int* __restrict__ targ, const int* __restrict__ terms,
              const int* __restrict__ deltas, const int* __restrict__ wa0,
              const int* __restrict__ wb0, const int* __restrict__ hist_a,
              const int* __restrict__ hist_b,
              const int* __restrict__ num_terms, int* __restrict__ res,
              int* __restrict__ wa_out, int* __restrict__ wb_out,
              int* __restrict__ ha_out, int* __restrict__ hb_out, int L,
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

  const size_t row = (size_t)L * C;
  const int* in = targ + (size_t)lane * C;
  int* o = res + (size_t)lane * C;
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
    o[0] = va;
    if (!MONO) o[1] = vb;
    for (int k = 0; k < nt; ++k) {
      if (MONO)
        va = apply_mono(term[k], delta[k], wa[k], ra[k], m, va);
      else
        apply_stereo(term[k], delta[k], wa[k], wb[k], ra[k], rb[k], m, va,
                     vb);
    }
  }

  if (STATE) {
    for (int k = 0; k < MAX_NTERMS; ++k) {
      int i = lane * MAX_NTERMS + k;
      bool run = k < nt;
      wa_out[i] = run ? wa[k] : wa0[i];
      if (!MONO) wb_out[i] = run ? wb[k] : wb0[i];
      for (int j = 0; j < 8; ++j) {
        ha_out[i * 8 + j] = run ? ra[k][j] : hist_a[i * 8 + j];
        if (!MONO) hb_out[i * 8 + j] = run ? rb[k][j] : hist_b[i * 8 + j];
      }
    }
  }
}

}  // namespace

// targ and res (T, L, C) int32; terms, deltas, wa0, wb0 (L, 16) and
// hist_a/hist_b (L, 16, 8) int32; num_terms (L,) int32. With `state`, the
// final weights wa_out/wb_out (L, 16) and rings ha_out/hb_out (L, 16, 8)
// int32 (mono: the b arrays are neither read nor written). Returns the
// launch's CUDA error code.
extern "C" int wvpk_encode_invert(const void* targ, const void* terms,
                                  const void* deltas, const void* wa0,
                                  const void* wb0, const void* hist_a,
                                  const void* hist_b, const void* num_terms,
                                  void* res, void* wa_out, void* wb_out,
                                  void* ha_out, void* hb_out, int L, int T,
                                  int mono, int state, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define WVPK_INVERT_ARGS                                                    \
  (const int*)targ, (const int*)terms, (const int*)deltas,                 \
      (const int*)wa0, (const int*)wb0, (const int*)hist_a,                \
      (const int*)hist_b, (const int*)num_terms, (int*)res, (int*)wa_out, \
      (int*)wb_out, (int*)ha_out, (int*)hb_out, L, T
  if (mono && state)
    invert_kernel<true, true><<<grid, block, 0, s>>>(WVPK_INVERT_ARGS);
  else if (mono)
    invert_kernel<true, false><<<grid, block, 0, s>>>(WVPK_INVERT_ARGS);
  else if (state)
    invert_kernel<false, true><<<grid, block, 0, s>>>(WVPK_INVERT_ARGS);
  else
    invert_kernel<false, false><<<grid, block, 0, s>>>(WVPK_INVERT_ARGS);
#undef WVPK_INVERT_ARGS
  return (int)cudaGetLastError();
}
