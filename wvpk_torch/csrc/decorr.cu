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
// - A chain of the decode-only table (WVPK_DECODE_CHAIN_TABLE: the 16
//   terms of WavPack's very high mode) holds twice the state of the
//   longest shared chain: 102 live ring slots and 32 weights in stereo,
//   past what one thread keeps in registers beside the step's work (one
//   thread spills). Its kernel (decorr_cluster) cuts the chain into
//   SPLIT_STAGES stages of whole passes and gives each a CTA of a thread
//   block cluster, each CTA on an SM of its own (its dynamic shared
//   memory is more than half an SM's); warp w of every CTA runs its
//   stage on the same 32 lanes. Stage 0 stages the residuals and runs the
//   first passes; each stage writes each tile's outputs into the next
//   stage's ring in that CTA's shared memory (distributed shared memory),
//   signalled by an mbarrier there, and the next stage gives the slot
//   back through an mbarrier in the writer's CTA, so a stage runs up to
//   RING_TILES tiles ahead of the next and none waits at a block-wide
//   barrier. The last stage runs its passes, the post step, the CRCs and
//   either store as a chain kernel's thread does, reading its ring where
//   that thread reads its staging ring. Every stage's weights and rings
//   stay registers, and each SM runs one stage's loop on its four
//   sub-partitions. The same stages as warps of one block, meeting at a
//   barrier after each tile, did not overlap (PERF.md, Findings).
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
// - The packed store (PACKED, never with WVC): for a bucket whose payload
//   is delivered as packed PCM, the kernel writes that payload itself, the
//   (L, W) words of little-endian bytes ops/pack.py::pack_samples makes,
//   with what ops/post.py does between them folded into the store: the
//   fixup's integer arm (v << shift, mod 32) and, for a hybrid lane, its
//   clip to the stored width; the +128 of 8-bit PCM; the pad past the
//   lane's sample count (0x80 bytes at 1 byte a sample, else zeros); and
//   mask_muted, a muted lane's whole row rewritten as pad at its end. A
//   thread keeps the 8 samples of a step group in registers, packs them
//   and stores the group's words to its lane's row (16-byte stores where
//   the row is aligned to them); the warp writes the rows' pad past their
//   samples together. Its plain version is
//   ops/decorr.py::decorr_post_packed.
// Otherwise samples in (T, L, C) layout make a warp's stores at one
// sample index contiguous. Past a lane's sample count the output is zero;
// the caller masks muted lanes.

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
  // the packed store's: per lane the entropy decode's EOF flag and the
  // fixup's shift; bytes a sample (1-3, the stored width); the hybrid clip
  const int *broke, *shift;
  int L, T, bps, hybrid;
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

// One sample through the chain, the post step and the CRCs; stored to
// the (T, L, C) output, or, PACKED, kept in `pv` for the group's pack.
// Its inputs `st` are a staging ring, or a view laid out as one (the
// cluster kernel's last stage: its hand-off ring, with WVC the
// corrections 2 BUF on).
template <bool MONO, bool WVC, bool PACKED, class State,
          class In = Stage<MONO, WVC>>
struct Lane {
  static constexpr int C = MONO ? 1 : 2;
  static constexpr bool packed = PACKED;
  State& s;
  const In& st;
  int* o;
  size_t row;
  bool jt;
  int thr, ns_lane;
  uint32_t crc, crc_l;
  int fb, fb_l;
  int pv[8 * C];

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
    if (PACKED) {
      pv[m * C] = out_l;
      if (!MONO) pv[m * C + 1] = out_r;
    } else {
      int* op = o + (size_t)t * row;
      op[0] = out_l;
      if (!MONO) op[1] = out_r;
    }
  }

  // Step slot m of the group lies past the lane's sample count.
  __device__ __forceinline__ void pad(int m) {
    pv[m * C] = 0;
    if (!MONO) pv[m * C + 1] = 0;
  }
};

// The end of a lane's scan to the (T, L, C) store: zeros from its sample
// count ns to T, then its CRCs and first bad sample.
template <bool MONO, bool WVC, class L>
__device__ __forceinline__ void finish_lane(const Args& a, int lane, int ns,
                                            size_t row, const L& ln) {
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

// A lane's whole scan: staging, the steps in groups of 8 (m = t & 7 a
// constant in each), zeros past its sample count, the CRCs. It keeps its
// own copy of scan_tile's loop: through scan_tile two of its wvc kernels
// compile to other register counts (PERF.md, Findings).
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
  Lane<MONO, WVC, false, State> ln{
      s,      st,     a.out + (size_t)lane * C, row, a.joint[lane] != 0,
      a.mute_thr[lane], ns_lane, 0xFFFFFFFFu, 0xFFFFFFFFu, ns_lane, ns_lane};
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
  finish_lane<MONO, WVC>(a, lane, ns, row, ln);
}

// -- the packed store -------------------------------------------------------

// A lane's fixup (ops/post.py::fixup, integer arm): with CLIP (a hybrid
// bucket) the clip to the stored width, bps bytes (UnpackUtils.cs:
// 1350-1393), then the shift, mod 32.
struct Fix {
  int sh = 0, lo = 0, hi = 0;

  Fix() = default;
  __device__ __forceinline__ Fix(int shift, int bps) : sh(shift & 31) {
    hi = (bps == 1 ? 127 : bps == 2 ? 32767 : 8388607) >> sh;
    lo = (bps == 1 ? -128 : bps == 2 ? -32768 : -8388608) >> sh;
  }

  template <bool CLIP>
  __device__ __forceinline__ unsigned apply(int v) const {
    if (CLIP) v = v < lo ? lo : v > hi ? hi : v;
    return (unsigned)v << sh;
  }
};

// Words [0, n) of w at g, n <= N; 16- or 8-byte stores where g is aligned
// to them and all N are stored.
template <int N>
__device__ __forceinline__ void store_words(unsigned* g, const unsigned* w,
                                            int n) {
  const uintptr_t at = (uintptr_t)g;
  if (n == N && N % 4 == 0 && at % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      ((uint4*)g)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                  w[4 * i + 3]);
  } else if (n == N && N % 2 == 0 && at % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      ((uint2*)g)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) g[i] = w[i];
  }
}

// A group's 8 C samples, fixed up, as the 2 C BPS words of their
// little-endian bytes (ops/pack.py::pack_samples), the first n of them
// stored at g.
template <bool MONO, int BPS, bool CLIP>
__device__ __forceinline__ void pack_store(const int* v, const Fix& fx,
                                           unsigned* g, int n) {
  constexpr int C = MONO ? 1 : 2;
  constexpr int N = 2 * C * BPS;
  unsigned w[N];
  if (BPS == 2) {
#pragma unroll
    for (int j = 0; j < 4 * C; ++j)
      w[j] = (fx.template apply<CLIP>(v[2 * j]) & 0xFFFFu) |
             (fx.template apply<CLIP>(v[2 * j + 1]) << 16);
  } else if (BPS == 1) {
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) {
      unsigned x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x |= ((fx.template apply<CLIP>(v[4 * j + i]) + 128u) & 0xFFu)
             << (8 * i);
      w[j] = x;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) {
      const unsigned v0 = fx.template apply<CLIP>(v[4 * j]),
                     v1 = fx.template apply<CLIP>(v[4 * j + 1]),
                     v2 = fx.template apply<CLIP>(v[4 * j + 2]),
                     v3 = fx.template apply<CLIP>(v[4 * j + 3]);
      w[3 * j] = (v0 & 0xFFFFFFu) | (v1 << 24);
      w[3 * j + 1] = ((v1 >> 8) & 0xFFFFu) | (v2 << 16);
      w[3 * j + 2] = ((v2 >> 16) & 0xFFu) | (v3 << 8);
    }
  }
  store_words<N>(g, w, n);
}

// pack_store for the launch's bytes a sample and clip, both uniform
// across the launch, so each group takes one branch.
template <bool MONO>
__device__ __forceinline__ void pack_group(const int* v, const Fix& fx,
                                           int bps, bool clip, unsigned* g,
                                           int n) {
  if (clip) {
    if (bps == 2)
      pack_store<MONO, 2, true>(v, fx, g, n);
    else if (bps == 1)
      pack_store<MONO, 1, true>(v, fx, g, n);
    else
      pack_store<MONO, 3, true>(v, fx, g, n);
  } else {
    if (bps == 2)
      pack_store<MONO, 2, false>(v, fx, g, n);
    else if (bps == 1)
      pack_store<MONO, 1, false>(v, fx, g, n);
    else
      pack_store<MONO, 3, false>(v, fx, g, n);
  }
}

// Words [from, to) of g set to `pad` by the warp, its threads (`col`,
// 0-31) on neighbouring words (16-byte stores between the ends' 16-byte
// bounds).
__device__ __forceinline__ void fill_words(unsigned* g, size_t from,
                                           size_t to, unsigned pad,
                                           unsigned col) {
  unsigned* p = g + from;
  unsigned* e = g + to;
  unsigned* a16 = (unsigned*)(((uintptr_t)p + 15) & ~(uintptr_t)15);
  if (a16 > e) a16 = e;
  uint4* v = (uint4*)a16;
  uint4* ve = (uint4*)((uintptr_t)e & ~(uintptr_t)15);
  if (ve < v) ve = v;
  for (unsigned* q = p + col; q < a16; q += STAGE_LANES) *q = pad;
  const uint4 pad4 = make_uint4(pad, pad, pad, pad);
  for (uint4* q = v + col; q < ve; q += STAGE_LANES) *q = pad4;
  for (unsigned* q = (unsigned*)ve + col; q < e; q += STAGE_LANES)
    *q = pad;
}

// A packed lane's row of the payload, the (L, W) words, W = T C bps / 4
// (T C bps is a multiple of 4), and what its groups' pack takes: the
// lane's fixup, the launch's bytes a sample and clip (both uniform across
// the launch, so each group takes one branch), the words of a group of 8
// steps. Row{} for the (T, L, C) store, which packs nothing.
struct Row {
  unsigned* mine = nullptr;
  Fix fx;
  int bps = 0, gw = 0;
  bool clip = false;
};

template <bool MONO>
__device__ __forceinline__ Row packed_row(const Args& a, unsigned* mine,
                                          int shift) {
  constexpr int C = MONO ? 1 : 2;
  return {mine, Fix(shift, a.bps), a.bps, 8 * C * a.bps / 4, a.hybrid != 0};
}

// Tile k of a lane's scan: the steps below ns in groups of 8 (m = t & 7 a
// constant in each), each by `ln.step(t, m)` (a Lane, or an inner stage's
// Pass). A packed Lane's thread packs its lane's groups and
// stores them to its row (2 C bps words, in 16-byte stores where the row
// allows; a warp's store lands on 32 rows, but it is one or two stores a
// group, spread through the scan, where a warp writing shared-memory
// tiles row by row stalls on its bursts of stores: PERF.md, Findings);
// the steps past ns in the group are pad, and only the words of steps
// below T are stored.
template <bool MONO, class Steps>
__device__ __forceinline__ void scan_tile(const Args& a, int k, int ns,
                                          Steps& ln, const Row& r) {
  constexpr int C = MONO ? 1 : 2;
#pragma unroll 1
  for (int t8 = k * TILE; t8 < k * TILE + TILE; t8 += 8) {
    if (t8 + 8 <= ns) {
#pragma unroll
      for (int m = 0; m < 8; ++m) ln.step(t8 + m, m);
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (t8 + m < ns)
          ln.step(t8 + m, m);
        else if constexpr (Steps::packed)
          ln.pad(m);
      }
    }
    if constexpr (Steps::packed) {
      const int n = min(8, a.T - t8) * C * r.bps / 4;
      pack_group<MONO>(ln.pv, r.fx, r.bps, r.clip,
                       r.mine + (size_t)t8 / 8 * r.gw, n);
    }
  }
}

// The end of a warp's packed scan, run by the warp (fill_words strides
// by its threads, this one's column `col`) once every lane's groups are
// stored: each lane's CRC and first bad sample as the unpacked scan's;
// the pad of each row past the words its groups wrote (its ntiles tiles)
// up to W (0x80 bytes at 1 byte a sample, else zeros); the row of a
// muted lane (`broke`, or a sample out of range before its sample count)
// rewritten as pad. The rows are the warp's lanes [base, base + 32)
// clipped to lane1, from `out`.
template <bool MONO, bool WVC, class State, class In>
__device__ __forceinline__ void finish_packed(
    const Args& a, int base, int lane1, int lane, bool active, int ns_lane,
    int ntiles, const Lane<MONO, WVC, true, State, In>& ln, unsigned* out,
    size_t W, unsigned col) {
  constexpr int C = MONO ? 1 : 2;
  if (active) {
    a.crc_out[lane] = (int)ln.crc;
    a.first_bad[lane] = ln.fb;
  }
  const int bps = a.bps;
  const unsigned pad = bps == 1 ? 0x80808080u : 0u;
  // the words each lane's groups wrote
  const unsigned long long done =
      (unsigned long long)min(ntiles * TILE, a.T) * C * bps / 4;
  const int rows = min(STAGE_LANES, lane1 - base);
  for (int r = 0; r < rows; ++r)
    fill_words(out + r * W, __shfl_sync(0xFFFFFFFFu, done, r), W, pad,
               col);
  unsigned muted = __ballot_sync(
      0xFFFFFFFFu, active && (a.broke[lane] != 0 || ln.fb < ns_lane));
  if (muted) __syncwarp();  // the rows' own stores before their rewrite
  while (muted) {
    const int r = __ffs(muted) - 1;
    muted &= muted - 1;
    fill_words(out + r * W, 0, W, pad, col);
  }
}

// The packed scan of a block's lanes [base, base + 32) clipped to lane1:
// each thread's lane through scan_tile into its row of the payload, then
// finish_packed.
template <bool MONO, class State>
__device__ __forceinline__ void scan_packed(const Args& a, int base,
                                            int lane1, bool active,
                                            int* ring, State& s) {
  constexpr int C = MONO ? 1 : 2;
  const int lane = base + (int)threadIdx.x;
  const int ns_lane = active ? a.nsamples[lane] : 0;
  const int ns = max(min(ns_lane, a.T), 0);
  const size_t row = (size_t)a.L * C;
  Stage<MONO, false> st{ring + threadIdx.x * C,
                        a.res + (size_t)(active ? lane : 0) * C, nullptr,
                        row, ns};
  Lane<MONO, false, true, State> ln{
      s, st, nullptr, row, active && a.joint[lane] != 0,
      active ? a.mute_thr[lane] : 0, ns_lane, 0xFFFFFFFFu, 0xFFFFFFFFu,
      ns_lane, ns_lane};
  const size_t W = (size_t)a.T * C * a.bps / 4;
  unsigned* out = (unsigned*)a.out + (size_t)base * W;
  const Row r = packed_row<MONO>(a, out + threadIdx.x * W,
                                 active ? a.shift[lane] : 0);
  const int ntiles = (ns + TILE - 1) / TILE;
  if (ntiles > 0) st.fetch(0);
  for (int k = 0; k < ntiles; ++k) {
    st.advance(k, ntiles);
    scan_tile<MONO>(a, k, ns, ln, r);
  }
  finish_packed(a, base, lane1, lane, active, ns_lane, ntiles, ln, out, W,
                threadIdx.x);
}

// A block's 32 lanes from lane0 + 32 blockIdx.x, up to lane1, with chain
// state `s` (its `load` reads a lane's seeds).
template <bool MONO, bool WVC, bool PACKED, class State>
__device__ __forceinline__ void run_block(const Args& a, int lane0,
                                          int lane1, State& s) {
  static_assert(!(PACKED && WVC), "the packed store has no wvc arm");
  __shared__ __align__(16) int ring[ring_ints<MONO, WVC>()];
  const int base = lane0 + blockIdx.x * THREADS;
  const int lane = base + threadIdx.x;
  if constexpr (PACKED) {
    const bool active = lane < lane1;
    if (active) s.load(a, lane);
    scan_packed<MONO>(a, base, lane1, active, ring, s);
  } else {
    if (lane >= lane1) return;
    s.load(a, lane);
    scan<MONO, WVC>(a, lane, ring, s);
  }
}

template <bool MONO, bool WVC, bool PACKED, int... TV>
__global__ void __launch_bounds__(THREADS)
decorr_chain(Args a, int lane0, int lane1) {
  ChainState<MONO, TV...> s;
  run_block<MONO, WVC, PACKED>(a, lane0, lane1, s);
}

template <bool MONO, bool WVC, bool PACKED>
__global__ void __launch_bounds__(THREADS)
decorr_generic(Args a, int lane0, int lane1) {
  GenericState<MONO> s;
  run_block<MONO, WVC, PACKED>(a, lane0, lane1, s);
}

// -- the pipelined kernel of a long chain ------------------------------------

template <int... TV>
struct Terms {
  static constexpr int K = sizeof...(TV);
};

// Split<N, Terms<>, Terms<TV...>>: ::front the first N terms, ::back the
// others.
template <int N, class F, class B>
struct Split;
template <int N, int... F, int B0, int... B>
struct Split<N, Terms<F...>, Terms<B0, B...>>
    : Split<N - 1, Terms<F..., B0>, Terms<B...>> {};
template <int... F, int B0, int... B>
struct Split<0, Terms<F...>, Terms<B0, B...>> {
  using front = Terms<F...>;
  using back = Terms<B0, B...>;
};
template <int... F>
struct Split<0, Terms<F...>, Terms<>> {
  using front = Terms<F...>;
  using back = Terms<>;
};

template <bool MONO, class T>
struct StateOf;
template <bool MONO, int... TV>
struct StateOf<MONO, Terms<TV...>> {
  using type = ChainState<MONO, TV...>;
};

// The state of passes [LO, HI) of the chain Chain (a Terms).
template <bool MONO, int LO, int HI, class Chain>
using PassesState = typename StateOf<
    MONO, typename Split<LO, Terms<>, typename Split<HI, Terms<>, Chain>::
                                          front>::back>::type;

// The first pass of stage j of a chain of K passes cut into S stages: as
// even as whole passes allow, the last stage's post step, CRCs and store
// weighing about one pass.
__host__ __device__ constexpr int stage_cut(int K, int S, int j) {
  return j >= S ? K : (2 * j * (K + 1) + S) / (2 * S);
}

// A lane's seeds from pass k0 on, as ChainState::load reads them: the
// (L, 16) and (L, 16, 8) arrays offset by k0 passes.
struct Seeds {
  const int *deltas, *wa0, *wb0, *hist_a, *hist_b;
};

__device__ __forceinline__ Seeds seeds_from(const Args& a, int k0) {
  return {a.deltas + k0, a.wa0 + k0, a.wb0 + k0, a.hist_a + 8 * k0,
          a.hist_b + 8 * k0};
}

// The stages of a long chain's cluster: a CTA each, each on an SM of its
// own.
constexpr int SPLIT_STAGES = 4;
// The warps of a cluster's CTA: warp w of every CTA runs its stage on the
// same 32 lanes.
constexpr int CLUSTER_WARPS = 4;
// The tiles of a hand-off ring: how far a stage may run ahead of the next
// (2 ran as fast as 4 in stereo and faster in mono: PERF.md, Findings).
constexpr int RING_TILES = 2;
static_assert(RING_TILES == 2, "a warp's hand-off ring is laid out as a "
                               "staging ring: stage 0 stages its residuals "
                               "in it, and the last stage's corrections "
                               "sit 2 tiles on, where Lane reads them");
// A CTA's mbarriers, per warp and ring slot: `full`, its input ring's slot
// written by the stage before, and `empty`, its output ring's slot (in the
// next stage's CTA) read by the next stage; each takes an arrival of each
// thread of the reading warp.
constexpr int CLUSTER_BARRIERS = 2 * CLUSTER_WARPS * RING_TILES;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The shared::cluster address of `p` in the cluster's CTA `rank`.
__device__ __forceinline__ unsigned peer_addr(const void* p, int rank) {
  unsigned q;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(q)
               : "r"(smem_addr(p)), "r"(rank));
  return q;
}

// Every thread of the cluster meets here; what each wrote before is
// visible to all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival, releasing this thread's earlier reads and writes, on the
// barrier at shared::cluster address `bar` (in another CTA: as CUTLASS's
// ClusterBarrier arrives on a peer's barrier to give back a buffer).
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival on this CTA's barrier `bar` that also expects `bytes` more
// of the stores that complete on it (st.async).
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Until the phase of parity `parity` of this CTA's barrier `bar` has
// completed, acquiring what its arrivals and the stores completing on it
// released.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned at = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(at), "r"(parity)
        : "memory");
  } while (!done);
}

// A thread's column of a hand-off ring of RING_TILES tiles, laid out as a
// staging ring's buffers: step t in slot (t / TILE) % RING_TILES.
template <bool MONO>
struct Ring {
  static constexpr int ROW = STAGE_LANES * (MONO ? 1 : 2);
  static constexpr int BUF = TILE * ROW;
  int* sm;

  __device__ __forceinline__ int* at(int t) const {
    return sm + ((t / TILE) % RING_TILES) * BUF + (t % TILE) * ROW;
  }
};

// A thread's column of the next stage's hand-off ring, laid out as Ring,
// by its shared::cluster address: `put` stores step t's values there
// with st.async, each store completing its bytes on the slot's `full`
// barrier in that CTA, so the writer never waits for its stores.
template <bool MONO>
struct RemoteRing {
  unsigned data, full;  // the column's slot 0, the slots' first barrier

  __device__ __forceinline__ void put(int t, int va, int vb) const {
    const int slot = (t / TILE) % RING_TILES;
    const unsigned at =
        data + 4u * (unsigned)(slot * Ring<MONO>::BUF +
                               (t % TILE) * Ring<MONO>::ROW);
    const unsigned bar = full + 8u * (unsigned)slot;
    if (MONO)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
          "%1, [%2];\n" ::"r"(at),
          "r"(va), "r"(bar)
          : "memory");
    else
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
          "[%0], {%1, %2}, [%3];\n" ::"r"(at),
          "r"(va), "r"(vb), "r"(bar)
          : "memory");
  }
};

// An inner stage's step: its passes on step t's values from `in` (a
// staging ring or a hand-off ring), their outputs put into `out`, the
// next stage's hand-off ring, at step t.
template <bool MONO, class State, class In>
struct Pass {
  static constexpr bool packed = false;
  State& s;
  const In& in;
  const RemoteRing<MONO>& out;

  __device__ __forceinline__ void step(int t, int m) {
    const int* v = in.at(t);
    int va = v[0];
    int vb = MONO ? 0 : v[1];
    s.apply(m, va, vb);
    out.put(t, va, vb);
  }
};

// What every CTA of a cluster knows of a warp's lanes: the 32 lanes from
// lane0 + 32 (CLUSTER_WARPS cluster + warp), up to lane1; column `col`
// of each of the warp's rings is lane `lane`'s; `rounds` the warp's most
// tiles, the tiles each stage hands on.
struct Block {
  int col, base, lane, ns_lane, ns, ntiles, rounds;
  bool active;
  size_t row, at;
};

// Stage J of a cluster's scan, run by CTA J on the chain's passes
// [stage_cut(J), stage_cut(J + 1)), warp w on its lanes. A CTA's dynamic
// shared memory holds its barriers, then a warp's hand-off ring, laid
// out as a staging ring (stage 0 stages its residuals in its own), and
// with WVC the corrections' staging tiles after it. Stage J puts
// each tile's outputs into stage J + 1's ring (distributed shared memory,
// st.async), each store completing on the slot's `full` barrier there;
// each thread of stage J + 1 arrives on that barrier expecting its
// lane's bytes of the tile, waits for the phase, reads the tile and
// arrives on the slot's `empty` barrier in stage J, which waits for it
// before it writes that slot again. So a stage may run up to RING_TILES
// tiles ahead of the next, and no stage waits for the ones before it but
// through its input. Every stage runs its tiles through scan_tile: an
// inner stage's steps its passes (Pass), the last stage's its passes and
// then what scan or scan_packed does per step (Lane, its staging ring the
// hand-off ring and the corrections it stages itself), and their tails
// (finish_lane, finish_packed).
template <bool MONO, bool WVC, bool PACKED, int J, class Chain>
__device__ __forceinline__ void cluster_stage(const Args& a, const Block& b,
                                              int lane1, int w, int* rings,
                                              unsigned long long* bars) {
  constexpr int S = SPLIT_STAGES;
  constexpr int C = MONO ? 1 : 2;
  constexpr int BUF = Ring<MONO>::BUF;
  constexpr int LO = stage_cut(Chain::K, S, J);
  constexpr int HI = stage_cut(Chain::K, S, J + 1);
  static_assert(LO < HI, "a stage without passes");
  using State = PassesState<MONO, LO, HI, Chain>;
  State s;
  if (b.active) s.load(seeds_from(a, LO), b.lane);
  unsigned long long* full = bars + w * RING_TILES;
  unsigned long long* empty = bars + (CLUSTER_WARPS + w) * RING_TILES;
  // the warp's hand-off ring, this thread's column; at the same offset in
  // every CTA
  int* mine = rings + w * (RING_TILES + (WVC ? 2 : 0)) * BUF + b.col * C;
  const Ring<MONO> ring{mine};
  // the hand-off around tile k: before it, its input landed (its lane's
  // bytes of the tile expected) and its output slot free; after it, the
  // input slot given back
  auto take = [&](int k) {
    const unsigned round = (unsigned)(k / RING_TILES) & 1u;
    if (J > 0) {
      mbar_expect(full + k % RING_TILES,
                  4 * C * min(max(b.ns - k * TILE, 0), TILE));
      mbar_wait(full + k % RING_TILES, round);
    }
    if (J + 1 < S) mbar_wait(empty + k % RING_TILES, round ^ 1u);
  };
  const unsigned empty_prev = J > 0 ? peer_addr(empty, J - 1) : 0u;
  auto give = [&](int k) {
    if (J > 0) mbar_arrive(empty_prev + 8 * (k % RING_TILES));
  };

  if constexpr (J + 1 < S) {
    const RemoteRing<MONO> out{peer_addr(mine, J + 1),
                               peer_addr(full, J + 1)};
    if constexpr (J == 0) {
      Stage<MONO, false> in{mine, a.res + b.at, nullptr, b.row, b.ns};
      Pass<MONO, State, Stage<MONO, false>> p{s, in, out};
      if (b.ntiles > 0) in.fetch(0);
      for (int k = 0; k < b.rounds; ++k) {
        take(k);
        if (k < b.ntiles) {
          in.advance(k, b.ntiles);
          scan_tile<MONO>(a, k, b.ns, p, Row{});
        }
        give(k);
      }
    } else {
      Pass<MONO, State, Ring<MONO>> p{s, ring, out};
      for (int k = 0; k < b.rounds; ++k) {
        take(k);
        if (k < b.ntiles) scan_tile<MONO>(a, k, b.ns, p, Row{});
        give(k);
      }
    }
  } else {
    Stage<MONO, false> cs{mine + 2 * BUF, WVC ? a.corr + b.at : nullptr,
                          nullptr, b.row, b.ns};
    const int lane = b.lane, ns = b.ns, ns_lane = b.ns_lane;
    const bool active = b.active;
    Lane<MONO, WVC, PACKED, State, Ring<MONO>> ln{
        s, ring, PACKED ? nullptr : a.out + b.at, b.row,
        active && a.joint[lane] != 0, active ? a.mute_thr[lane] : 0,
        ns_lane, 0xFFFFFFFFu, 0xFFFFFFFFu, ns_lane, ns_lane};
    const size_t W = PACKED ? (size_t)a.T * C * a.bps / 4 : 0;
    unsigned* out = (unsigned*)a.out + (size_t)b.base * W;
    const Row r = PACKED ? packed_row<MONO>(a, out + b.col * W,
                                            active ? a.shift[lane] : 0)
                         : Row{};
    if (WVC && b.ntiles > 0) cs.fetch(0);
    for (int k = 0; k < b.rounds; ++k) {
      take(k);
      if (k < b.ntiles) {
        if (WVC) cs.advance(k, b.ntiles);
        scan_tile<MONO>(a, k, ns, ln, r);
      }
      give(k);
    }
    if constexpr (PACKED)
      finish_packed(a, b.base, lane1, lane, active, ns_lane, b.ntiles, ln,
                    out, W, (unsigned)b.col);
    else if (active)
      finish_lane<MONO, WVC>(a, lane, ns, b.row, ln);
  }
}

template <bool MONO, bool WVC, bool PACKED, class Chain, size_t... J>
__device__ __forceinline__ void run_cluster(const Args& a, int lane0,
                                            int lane1,
                                            unsigned long long* smem,
                                            std::index_sequence<J...>) {
  constexpr int C = MONO ? 1 : 2;
  unsigned long long* bars = smem;
  int* rings = (int*)(smem + CLUSTER_BARRIERS);
  for (int i = threadIdx.x; i < CLUSTER_BARRIERS; i += blockDim.x)
    mbar_init(bars + i, STAGE_LANES);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  cluster_sync();  // every CTA's barriers set before any arrival
  const int w = (int)threadIdx.x / THREADS;
  Block b;
  b.col = (int)threadIdx.x % THREADS;
  b.base = lane0 +
           ((int)blockIdx.x / SPLIT_STAGES * CLUSTER_WARPS + w) * THREADS;
  b.lane = b.base + b.col;
  b.active = b.lane < lane1;
  b.ns_lane = b.active ? a.nsamples[b.lane] : 0;
  b.ns = max(min(b.ns_lane, a.T), 0);
  b.row = (size_t)a.L * C;
  b.at = (size_t)(b.active ? b.lane : 0) * C;
  b.ntiles = (b.ns + TILE - 1) / TILE;
  b.rounds = __reduce_max_sync(0xFFFFFFFFu, b.ntiles);
  const int j = cluster_rank();
  ((j == (int)J ? cluster_stage<MONO, WVC, PACKED, (int)J, Chain>(
                      a, b, lane1, w, rings, bars)
                : void()),
   ...);
  cluster_sync();  // no CTA leaves while a peer may still reach into it
}

// The bytes of a cluster CTA's dynamic shared memory: its barriers, a
// warp's hand-off ring and, with WVC, its corrections' staging ring.
template <bool MONO, bool WVC>
constexpr int cluster_smem() {
  return 8 * CLUSTER_BARRIERS +
         4 * CLUSTER_WARPS * (RING_TILES + (WVC ? 2 : 0)) * Ring<MONO>::BUF;
}

template <bool MONO, bool WVC, bool PACKED, int... TV>
__global__ void __cluster_dims__(SPLIT_STAGES, 1, 1)
    __launch_bounds__(CLUSTER_WARPS * THREADS)
        decorr_cluster(Args a, int lane0, int lane1) {
  extern __shared__ __align__(16) unsigned long long cluster_shared[];
  run_cluster<MONO, WVC, PACKED, Terms<TV...>>(
      a, lane0, lane1, cluster_shared,
      std::make_index_sequence<SPLIT_STAGES>{});
}

// The SM (%smid) each CTA of a launch shaped as a cluster kernel's runs
// on, and whether it saw every CTA of the launch resident at once (within
// about a second): the launch a card test checks no two CTAs share an SM
// by.
__global__ void __cluster_dims__(SPLIT_STAGES, 1, 1)
    __launch_bounds__(CLUSTER_WARPS * THREADS)
        cluster_sm_probe(int* sm, int* all_resident, int* resident) {
  if (threadIdx.x == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(id));
    sm[blockIdx.x] = (int)id;
    atomicAdd(resident, 1);
    const long long t0 = clock64();
    int seen = 0;
    while ((seen = *(volatile int*)resident) < (int)gridDim.x &&
           clock64() - t0 < 2000000000LL) {
    }
    all_resident[blockIdx.x] = seen >= (int)gridDim.x;
  }
  __syncthreads();
}

// A kernel, the threads of its CTAs and their dynamic shared memory; the
// lanes a group of `ctas` CTAs (a cluster's, else one) takes.
struct Launch {
  void (*fn)(Args, int, int);
  int threads, smem, lanes, ctas;
};

// The kernel compiled for chain `id` (decorr_pass.cuh's tables;
// ops/decorr_cuda.py::CHAINS names the same list): a chain of
// WVPK_CHAIN_TABLE on decorr_chain, one of WVPK_DECODE_CHAIN_TABLE on
// decorr_cluster; else (an id of the other channel count too) the generic
// one.
template <bool MONO, bool WVC, bool PACKED>
Launch kernel_for(int id) {
#define WVPK_CHAIN(ID, MONO_, ...)                                         \
  case ID:                                                                 \
    if constexpr (MONO_ == MONO)                                           \
      return {decorr_chain<MONO, WVC, PACKED, __VA_ARGS__>, THREADS, 0,    \
              THREADS, 1};                                                 \
    break;
  switch (id) {
    WVPK_CHAIN_TABLE
    default:
      break;
  }
#undef WVPK_CHAIN
#define WVPK_CHAIN(ID, MONO_, ...)                                         \
  case ID:                                                                 \
    if constexpr (MONO_ == MONO)                                           \
      return {decorr_cluster<MONO, WVC, PACKED, __VA_ARGS__>,              \
              CLUSTER_WARPS * THREADS, cluster_smem<MONO, WVC>(),          \
              CLUSTER_WARPS * THREADS, SPLIT_STAGES};                      \
    break;
  switch (id) {
    WVPK_DECODE_CHAIN_TABLE
    default:
      break;
  }
#undef WVPK_CHAIN
  return {decorr_generic<MONO, WVC, PACKED>, THREADS, 0, THREADS, 1};
}

// The blocks and dynamic shared memory of kernel k's launch on `lanes`
// lanes, as kernel `fn` (k's, or the probe in its shape) takes them. A
// cluster kernel's CTAs take more than half an SM's shared memory, so no
// two of them share an SM (1 KB a block is the system's,
// cudaDevAttrReservedSharedMemoryPerBlock); past the default limit of
// 48 KB the kernel is given leave. Returns the CUDA error.
cudaError_t launch_shape(const Launch& k, const void* fn, int lanes,
                         int& blocks, int& smem) {
  blocks = (lanes + k.lanes - 1) / k.lanes * k.ctas;
  smem = k.smem;
  if (k.ctas > 1) {
    int dev = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e != cudaSuccess) return e;
    smem = max(smem, per_sm / 2);
  }
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  return cudaSuccess;
}

Launch launch_of(int chain, int mono, int wvc, bool packed) {
  return mono ? (wvc      ? kernel_for<true, true, false>(chain)
                 : packed ? kernel_for<true, false, true>(chain)
                          : kernel_for<true, false, false>(chain))
              : (wvc      ? kernel_for<false, true, false>(chain)
                 : packed ? kernel_for<false, false, true>(chain)
                          : kernel_for<false, false, false>(chain));
}

}  // namespace

// res, corr and out (T, L, C) int32, corr only with `wvc` (else null);
// terms, deltas, wa0, wb0 (L, 16) and hist_a/hist_b (L, 16, 8) int32;
// num_terms, nsamples, joint, mute_thr (L,) int32; crc, first_bad and,
// with `wvc`, crc_wvc (L,) int32. Without wvc, crc covers the output; with
// it, crc the lossy samples and crc_wvc the exact ones, and first_bad is the
// exact samples'. With `bps` 1-3 (never with wvc; 0: the (T, L, C) store),
// out is the packed payload, (L, T C bps / 4) int32 words, T C bps a
// multiple of 4, and broke and shift (L,) int32 are read (else null):
// every lane stores bps bytes a sample, and `hybrid` clips to them.
// One launch on `stream` of chain `chain`'s kernel (-1 or an id outside
// the table: the generic one) on lanes [lo, hi); the other lanes are not
// written. Returns its CUDA error.
extern "C" int wvpk_decorr_post(const void* res, const void* corr,
                                const void* terms, const void* deltas,
                                const void* wa0, const void* wb0,
                                const void* hist_a, const void* hist_b,
                                const void* num_terms, const void* nsamples,
                                const void* joint, const void* mute_thr,
                                void* out, void* crc, void* crc_wvc,
                                void* first_bad, const void* broke,
                                const void* shift, int L, int T, int mono,
                                int wvc, int bps, int hybrid, int chain,
                                int lo, int hi, void* stream) {
  const bool packed = bps != 0;
  if (lo < 0 || hi > L || lo >= hi ||
      (packed && (wvc || bps < 0 || bps > 3 ||
                  (long long)T * (mono ? 1 : 2) * bps % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  Args a{(const int*)res,          (const int*)corr,
         (const int*)terms,        (const int*)deltas,
         (const int*)wa0,          (const int*)wb0,
         (const int*)hist_a,       (const int*)hist_b,
         (const int*)num_terms,    (const int*)nsamples,
         (const int*)joint,        (const int*)mute_thr,
         (int*)out,                (int*)crc,
         (int*)crc_wvc,            (int*)first_bad,
         (const int*)broke,        (const int*)shift,
         L,                        T,
         bps,                      hybrid};
  const Launch k = launch_of(chain, mono, wvc, packed);
  void* params[] = {&a, &lo, &hi};
  int blocks = 0, smem = 0;
  cudaError_t e = launch_shape(k, (const void*)k.fn, hi - lo, blocks, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernel((const void*)k.fn, dim3(blocks), dim3(k.threads),
                       params, smem, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The CTAs of chain `chain`'s kernel launched on L lanes (mono, wvc and
// bps as wvpk_decorr_post's).
extern "C" int wvpk_decorr_ctas(int chain, int mono, int wvc, int bps,
                                int L) {
  const Launch k = launch_of(chain, mono, wvc, bps != 0);
  return (L + k.lanes - 1) / k.lanes * k.ctas;
}

// cluster_sm_probe launched on `stream` in the shape of chain `chain`'s
// cluster kernel on L lanes (its CTAs, threads and dynamic shared
// memory): sm and all_resident int32, wvpk_decorr_ctas of them, resident
// one int32, zeroed. Returns the CUDA error (cudaErrorInvalidValue where
// the chain's kernel is not a cluster kernel).
extern "C" int wvpk_decorr_cluster_probe(int chain, int mono, int wvc,
                                         int bps, int L, void* sm,
                                         void* all_resident, void* resident,
                                         void* stream) {
  const Launch k = launch_of(chain, mono, wvc, bps != 0);
  if (k.ctas == 1 || L <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0, smem = 0;
  cudaError_t e =
      launch_shape(k, (const void*)cluster_sm_probe, L, blocks, smem);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&sm, &all_resident, &resident};
  e = cudaLaunchKernel((const void*)cluster_sm_probe, dim3(blocks),
                       dim3(k.threads), params, smem, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
