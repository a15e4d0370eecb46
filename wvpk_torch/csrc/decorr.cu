// WavPack decorrelation with the post step folded in, for Hopper (sm_90a):
// one thread per lane; one kernel compiled for each term chain of a table,
// and a generic kernel for any chain.
//
// Replaces wvpk/ops/decorr_pallas.py::_decorr_kernel called with
// fold_post, and its static_terms / chain_segments unrolls. The plain
// version is wvpk_torch/ops/decorr.py::decorr_post. The wvc arm (plain
// version decorr.py::decorr_post_wvc) folds
// wvpk/engine/fused.py::fused_decode_wvc's post steps into the same pass:
// given each word's correction it runs the chain on the lossy residuals,
// adds the corrections after the chain and before the joint undo (the
// chain is linear in the residual for its lossy-driven predictions), and
// returns two CRCs: the lossy one, which the wv header checks, with its own
// mute point, and the exact one, which the wvc header checks, with the
// exact samples' mute point.
// Per sample, the lane's chain of up to 16 passes runs in order
// (UnpackUtils.cs:688-1240), each pass the body in decorr_pass.cuh that
// the encode kernels run too. Then, as fold_post does, the joint-stereo
// undo, the mute check and the running CRC (crc = 3 crc + x, a stereo
// pair 9 crc + 3 l + r) fold into the same sample loop
// (UnpackUtils.cs:609-646).
//
// What bounds it: a lane's samples form a serial recurrence through the
// weights and rings, so the parallelism is the lane count; a bucket of the
// bench corpus has ~8,300 lanes, ~two warps per SM on 132 SMs. A launch
// takes as long as one lane's chain: T steps, each issuing its
// passes' integer operations (~20 a pass) and the post step, with the
// recurrence of one pass (a 64-bit multiply-add, a shift and an add, from
// this sample's output to the next sample's prediction) as the floor.
// Device memory is far from the limit: 8 bytes in and 8 out per stereo
// sample.
//
// Design:
// - One kernel for each chain of a table (decorr_chain, the WVPK_CHAIN
//   lines of decorr_pass.cuh, ChainState there; ops/decorr_cuda.py::CHAINS
//   names the same list): the
//   chain's terms are template arguments and the time loop is unrolled by
//   8, so the ring slot m = t & 7, every pass index and every ring index
//   are constants. The weights and the 8-deep rings then live in
//   registers (ptxas: no stack frame), where a chain read at run time
//   keeps them in local memory, and within a group of 8 steps the
//   compiler overlaps pass k of one sample with the later passes of the
//   one before.
// - The generic kernel (decorr_generic) takes each lane's chain at run
//   time from per-thread arrays in local memory; it serves every other
//   chain and the mixed tail of a bucket.
// - Residuals (and, for wvc, corrections) are staged ahead (stage.cuh):
//   each thread copies its lane's next 32 steps into a double-buffered
//   ring in shared memory with cp.async while it computes the current 32,
//   so a step reads shared memory instead of waiting on device memory.
// - The wrapper splits a bucket into lane runs by chain (staging's
//   chain_segments) and launches each run's kernel on its lane range of
//   the (T, L, C) arrays (a lane offset and the row stride L, no copy).
//   A uniform bucket, the main path's among them, is one run. The runs of
//   a mixed bucket go on side streams, so they share the card: measured
//   against the runs in sequence and against one launch whose blocks
//   switch on their run's chain (PERF.md, Findings).
// Samples in (T, L, C) layout make a warp's stores at one sample index
// contiguous. Past a lane's sample count the output is zero; the caller
// masks muted lanes.

#include <cstdint>

#include <cuda_runtime.h>

#include "decorr_pass.cuh"
#include "stage.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;
static_assert(THREADS == STAGE_LANES, "one staging column a thread");

struct Args {
  const int *res, *corr, *terms, *deltas, *wa0, *wb0, *hist_a, *hist_b,
      *num_terms, *nsamples, *joint, *mute_thr;
  int *out, *crc_out, *crc_wvc_out, *first_bad;
  int L, T;
};

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

// One sample through the chain, the post step and the CRCs.
template <bool MONO, bool WVC, class State>
struct Lane {
  State& s;
  const Stage<MONO, WVC>& st;
  int* o;
  size_t row;
  bool jt;
  int thr, ns_lane;
  uint32_t crc, crc_l;
  int fb, fb_l;

  __device__ __forceinline__ void step(int t, int m) {
    const int* v = st.at(t);
    int va = v[0];
    int vb = MONO ? 0 : v[1];
    s.apply(m, va, vb);
    int out_l, out_r;
    if (WVC) {
      if (post<MONO>(va, vb, jt, thr, out_l, out_r) && fb_l == ns_lane)
        fb_l = t;
      if (t < fb_l) crc_step<MONO>(crc_l, out_l, out_r);
      const int* cv = v + 2 * Stage<MONO, WVC>::BUF;
      va = add32(va, cv[0]);
      if (!MONO) vb = add32(vb, cv[1]);
    }
    if (post<MONO>(va, vb, jt, thr, out_l, out_r) && fb == ns_lane) fb = t;
    if (t < fb) crc_step<MONO>(crc, out_l, out_r);
    int* op = o + (size_t)t * row;
    op[0] = out_l;
    if (!MONO) op[1] = out_r;
  }
};

// A lane's whole scan: staging, the steps in groups of 8 (m = t & 7 a
// constant in each), zeros past its sample count, the CRCs.
template <bool MONO, bool WVC, class State>
__device__ __forceinline__ void scan(const Args& a, int lane, int* ring,
                                     State& s) {
  constexpr int C = MONO ? 1 : 2;
  const int ns_lane = a.nsamples[lane];
  const int ns = max(min(ns_lane, a.T), 0);
  const size_t row = (size_t)a.L * C;
  Stage<MONO, WVC> st{ring + threadIdx.x * C,
                            a.res + (size_t)lane * C,
                            WVC ? a.corr + (size_t)lane * C : nullptr, row,
                            ns};
  Lane<MONO, WVC, State> ln{s,  st, a.out + (size_t)lane * C, row,
                            a.joint[lane] != 0, a.mute_thr[lane], ns_lane,
                            0xFFFFFFFFu, 0xFFFFFFFFu, ns_lane, ns_lane};
  const int ntiles = (ns + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
#pragma unroll 1
    for (int t8 = k * TILE; t8 < k * TILE + TILE; t8 += 8) {
      if (t8 + 8 <= ns) {
#pragma unroll
        for (int m = 0; m < 8; ++m) ln.step(t8 + m, m);
      } else {
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (t8 + m < ns) ln.step(t8 + m, m);
      }
    }
  }
  for (int t = ns; t < a.T; ++t) {
    int* op = ln.o + (size_t)t * row;
    op[0] = 0;
    if (!MONO) op[1] = 0;
  }
  if (WVC) {
    a.crc_out[lane] = (int)ln.crc_l;
    a.crc_wvc_out[lane] = (int)ln.crc;
  } else {
    a.crc_out[lane] = (int)ln.crc;
  }
  a.first_bad[lane] = ln.fb;
}

template <bool MONO, bool WVC, int... TV>
__global__ void __launch_bounds__(THREADS)
decorr_chain(Args a, int lane0, int lane1) {
  __shared__ __align__(16) int ring[ring_ints<MONO, WVC>()];
  const int lane = lane0 + blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lane1) return;
  ChainState<MONO, TV...> s;
  s.load(a, lane);
  scan<MONO, WVC>(a, lane, ring, s);
}

template <bool MONO, bool WVC>
__global__ void __launch_bounds__(THREADS)
decorr_generic(Args a, int lane0, int lane1) {
  __shared__ __align__(16) int ring[ring_ints<MONO, WVC>()];
  const int lane = lane0 + blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lane1) return;
  GenericState<MONO> s;
  s.load(a, lane);
  scan<MONO, WVC>(a, lane, ring, s);
}

using Kernel = void (*)(Args, int, int);

// A chain of WVPK_CHAIN_TABLE (decorr_pass.cuh; ops/decorr_cuda.py::CHAINS
// names the same list) by its id.
#define WVPK_CHAIN(ID, MONO_, ...)                                     \
  case ID:                                                             \
    if constexpr (MONO_ == MONO) return decorr_chain<MONO, WVC, __VA_ARGS__>; \
    break;

// The kernel compiled for chain `id`, else (an id of the other channel
// count too) the generic one.
template <bool MONO, bool WVC>
Kernel kernel_for(int id) {
  switch (id) {
    WVPK_CHAIN_TABLE
    default:
      break;
  }
  return decorr_generic<MONO, WVC>;
}

#undef WVPK_CHAIN

}  // namespace

// res, corr and out (T, L, C) int32, corr only with `wvc` (else null);
// terms, deltas, wa0, wb0 (L, 16) and hist_a/hist_b (L, 16, 8) int32;
// num_terms, nsamples, joint, mute_thr (L,) int32; crc, first_bad and,
// with `wvc`, crc_wvc (L,) int32. Without wvc, crc covers the output; with
// it, crc the lossy samples and crc_wvc the exact ones, and first_bad is the
// exact samples'. One launch on `stream` of chain `chain`'s kernel (-1 or
// an id outside the table: the generic one) on lanes [lo, hi); the other
// lanes are not written. Returns its CUDA error.
extern "C" int wvpk_decorr_post(const void* res, const void* corr,
                                const void* terms, const void* deltas,
                                const void* wa0, const void* wb0,
                                const void* hist_a, const void* hist_b,
                                const void* num_terms, const void* nsamples,
                                const void* joint, const void* mute_thr,
                                void* out, void* crc, void* crc_wvc,
                                void* first_bad, int L, int T, int mono,
                                int wvc, int chain, int lo, int hi,
                                void* stream) {
  if (lo < 0 || hi > L || lo >= hi) return (int)cudaErrorInvalidValue;
  Args a{(const int*)res,      (const int*)corr,
         (const int*)terms,    (const int*)deltas,
         (const int*)wa0,      (const int*)wb0,
         (const int*)hist_a,   (const int*)hist_b,
         (const int*)num_terms, (const int*)nsamples,
         (const int*)joint,    (const int*)mute_thr,
         (int*)out,            (int*)crc,
         (int*)crc_wvc,        (int*)first_bad,
         L,                    T};
  const Kernel fn =
      mono ? (wvc ? kernel_for<true, true>(chain)
                  : kernel_for<true, false>(chain))
           : (wvc ? kernel_for<false, true>(chain)
                  : kernel_for<false, false>(chain));
  void* params[] = {&a, &lo, &hi};
  const cudaError_t e = cudaLaunchKernel(
      (const void*)fn, dim3((hi - lo + THREADS - 1) / THREADS), dim3(THREADS),
      params, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
