// Decorrelation inversion for the device encoder, for Hopper (sm_90a): one
// thread per lane; one kernel compiled for each term chain of a table, and
// a run-time kernel for any chain.
//
// Replaces wvpk/ops/encode_pallas.py::_invert_kernel (decorr_invert_pallas)
// and its static_terms unroll. Its plain version is wvpk_torch/ops/
// encode_kernels.py::decorr_invert_warm, with the same arguments and
// results. Per sample the lane's passes are peeled off the target values
// last pass first (each subtracts its prediction; the cross terms -1/-2
// read the partner's value before this pass's peel), which gives the
// residuals the entropy coder codes; then the decode chain runs forward
// over those residuals, so the weights and rings advance exactly as the
// decoder's will. Both halves are csrc/decorr_pass.cuh, the decode
// kernel's pass body. With STATE the kernel also writes the final weights
// and rings (the warm seeding scan); slots past the lane's chain keep
// their seeds.
//
// What bounds it: a lane's samples form a serial recurrence through the
// weights and rings, so the parallelism is the lane count (a 768 s track
// at 4,096-sample blocks is ~8,300 lanes: two warps per SM). Each sample
// costs a peel and an apply of the chain, dependent integer operations on
// the lane's state; device memory moves 8 bytes in and 8 out per stereo
// sample (~0.16 ms of the card's bandwidth at the main launch).
//
// Design:
// - One kernel for each chain of WVPK_CHAIN_TABLE (decorr_pass.cuh;
//   ops/decorr_cuda.py::CHAINS) and STATE: the chain's terms are template
//   arguments of its ChainState, so the weights and the 8-deep rings are
//   registers (ptxas: no stack frame). Within a step a switch on the ring
//   slot m = t & 7 selects one copy of the peel, the residual's store and
//   the apply, with m a constant in each (every pass and ring index is
//   then one). With STATE the final weights and rings go out straight
//   from the registers, ring slots absolute as the plain version returns
//   them.
// - The run-time kernel (GenericState: the chain read from per-thread
//   arrays in local memory) serves every other chain, mono chains with
//   cross terms among them, and calls without `static_terms`.
// - The targets are staged ahead (stage.cuh): each thread copies its
//   lane's next 32 samples into a double-buffered ring in shared memory
//   with cp.async while it computes the current 32, so a step reads shared
//   memory instead of waiting on device memory. The launch asks for a
//   shared-memory carve-out no larger than its blocks on an SM take
//   (launch_staged), so the run-time kernel's local-memory state stays in
//   L1: without the hint it took 8.18-8.21 ms at the main launch against
//   5.76-5.81 with it, in turns on an NVIDIA H100 80GB HBM3 at 700 W
//   (kernel_ab.py; PERF.md); the chain kernels hold no local memory and
//   take the same time either way.
// Samples in (T, L, C) layout make a warp's loads and stores at one sample
// index contiguous.

#include <cstdint>
#include <cuda_runtime.h>

#include "decorr_pass.cuh"
#include "stage.cuh"

namespace {

using namespace wvpk;

constexpr int THREADS = 32;
static_assert(THREADS == STAGE_LANES, "one staging column a thread");

struct Args {
  const int *targ, *terms, *deltas, *wa0, *wb0, *hist_a, *hist_b, *num_terms;
  int* res;
  int *wa_out, *wb_out, *ha_out, *hb_out;
  int L, T;
};

// One sample: peel the chain off its targets (va, vb), write the
// residuals to o, apply the chain over them.
template <bool MONO, class Chain>
__device__ __forceinline__ void step(Chain& ch, int m, int va, int vb,
                                     int* o) {
  ch.peel(m, va, vb);
  o[0] = va;
  if (!MONO) o[1] = vb;
  ch.apply(m, va, vb);
}

// Ring slot m as a constant: one copy of the step for each case of t & 7.
// A chain read at run time indexes its rings at run time anyway, and takes
// them directly (eight copies of its loops only grow the code).
template <bool MONO, class Chain>
__device__ __forceinline__ void step_at(Chain& ch, int m, int va, int vb,
                                        int* o) {
  switch (m) {
    case 0: step<MONO>(ch, 0, va, vb, o); break;
    case 1: step<MONO>(ch, 1, va, vb, o); break;
    case 2: step<MONO>(ch, 2, va, vb, o); break;
    case 3: step<MONO>(ch, 3, va, vb, o); break;
    case 4: step<MONO>(ch, 4, va, vb, o); break;
    case 5: step<MONO>(ch, 5, va, vb, o); break;
    case 6: step<MONO>(ch, 6, va, vb, o); break;
    default: step<MONO>(ch, 7, va, vb, o); break;
  }
}

template <bool MONO>
__device__ __forceinline__ void step_at(GenericState<MONO>& ch, int m,
                                        int va, int vb, int* o) {
  step<MONO>(ch, m, va, vb, o);
}

// A lane's whole scan: its chain state, the staged targets, and with STATE
// the final state.
template <bool MONO, bool STATE, class Chain>
__device__ __forceinline__ void run(const Args& a, int* ring) {
  constexpr int C = MONO ? 1 : 2;
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.L) return;
  Chain ch;
  ch.load(a, lane);
  const size_t row = (size_t)a.L * C;
  Stage<MONO, 0> st{ring + threadIdx.x * C, a.targ + (size_t)lane * C,
                    nullptr, row, a.T};
  int* o = a.res + (size_t)lane * C;
  const int ntiles = (a.T + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
    const int t1 = min(k * TILE + TILE, a.T);
    for (int t = k * TILE; t < t1; ++t) {
      const int* in = st.at(t);
      step_at<MONO>(ch, t & 7, in[0], MONO ? 0 : in[1],
                    o + (size_t)t * row);
    }
  }
  if (STATE) ch.store(a, lane);
}

template <bool MONO, bool STATE, int... TV>
__global__ void __launch_bounds__(THREADS) invert_chain(Args a) {
  __shared__ __align__(16) int ring[ring_ints<MONO, 0>()];
  run<MONO, STATE, ChainState<MONO, TV...>>(a, ring);
}

template <bool MONO, bool STATE>
__global__ void __launch_bounds__(THREADS) invert_generic(Args a) {
  __shared__ __align__(16) int ring[ring_ints<MONO, 0>()];
  run<MONO, STATE, GenericState<MONO>>(a, ring);
}

using Kernel = void (*)(Args);

// A chain of WVPK_CHAIN_TABLE by its id.
#define WVPK_CHAIN(ID, MONO_, ...)                             \
  case ID:                                                     \
    if constexpr (MONO_ == MONO)                               \
      return invert_chain<MONO, STATE, __VA_ARGS__>;           \
    break;

// The kernel compiled for chain `id`, else (an id of the other channel
// count too) the run-time one.
template <bool MONO, bool STATE>
Kernel kernel_for(int id) {
  switch (id) {
    WVPK_CHAIN_TABLE
    default:
      break;
  }
  return invert_generic<MONO, STATE>;
}

#undef WVPK_CHAIN

}  // namespace

// targ and res (T, L, C) int32; terms, deltas, wa0, wb0 (L, 16) and
// hist_a/hist_b (L, 16, 8) int32; num_terms (L,) int32. With `state`, the
// final weights wa_out/wb_out (L, 16) and rings ha_out/hb_out (L, 16, 8)
// int32 (mono: the b arrays are neither read nor written). `chain`: the id
// of the chain every lane carries (ops/decorr_cuda.py::CHAINS), or -1 (or
// an id outside the table) for the run-time kernel, whose lanes may carry
// any chain. `device`: the ordinal of the card the pointers lie on.
// Returns the launch's CUDA error code.
extern "C" int wvpk_encode_invert(const void* targ, const void* terms,
                                  const void* deltas, const void* wa0,
                                  const void* wb0, const void* hist_a,
                                  const void* hist_b, const void* num_terms,
                                  void* res, void* wa_out, void* wb_out,
                                  void* ha_out, void* hb_out, int L, int T,
                                  int mono, int state, int chain,
                                  int device, void* stream) {
  Args a{(const int*)targ,   (const int*)terms,  (const int*)deltas,
         (const int*)wa0,    (const int*)wb0,    (const int*)hist_a,
         (const int*)hist_b, (const int*)num_terms, (int*)res,
         (int*)wa_out,       (int*)wb_out,       (int*)ha_out,
         (int*)hb_out,       L,                  T};
  const Kernel fn = mono ? (state ? kernel_for<true, true>(chain)
                                  : kernel_for<true, false>(chain))
                         : (state ? kernel_for<false, true>(chain)
                                  : kernel_for<false, false>(chain));
  void* params[] = {&a};
  const int blocks = (L + THREADS - 1) / THREADS;
  return (int)launch_staged((const void*)fn, blocks, device, params,
                            (cudaStream_t)stream);
}
