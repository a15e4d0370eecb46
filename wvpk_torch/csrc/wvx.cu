// INT32 wvx low-bit injection for Hopper (sm_90a): a warp per lane.
//
// Replaces wvpk/ops/post.py::wvx_inject, an XLA lax.scan and not a Pallas
// kernel: in eager PyTorch its plain version (wvpk_torch/ops/post.py::
// wvx_inject) is a Python loop of ~40 small launches per value. For each
// value in interleaved order (UnpackUtils.cs:1271-1314) it reads the
// sent_bits low bits the encoder moved to the wvx stream (fewer where
// max_width truncates), through the reference's getbits window: a bit
// count `bc` refilled in byte steps, a window of min(bc, 32) bits masked to
// sent_bits (mod-32 shifts, as in C#). Then the zeros/ones/dups
// re-expansion and the crc_x recurrence (crc = 9 crc + 3 lo16 + hi16). A
// FALSE_STEREO lane runs a second pass over zeros, as the reference's
// fixup does over the zero half of its buffer (UnpackUtils.cs:1265): it
// moves only the cursor and crc_x.
//
// What bounds it: 8 bytes read and written per value and the lane's
// stream once, ~0.033 ms for the bench's wvx bucket at the card's 3.35
// TB/s; it does ~70 integer instructions a value, and a lane's chunks are
// a chain of shuffles and dependent loads, so with 12 warps an SM the
// kernel is bound by latency, not by either. The scan looks serial, but
// nothing in it waits on the bits it reads:
//
// - The bits value k takes, btr_k, depend on the value and the lane's
//   sent_bits and max_width alone: sb, or mw - bit_length(pvalue) where
//   bit_length(pvalue) + sb > mw > 0, and 0 where nothing is read (sb <= 0,
//   a truncation to btr <= 0, or a value past the lane's count). So the
//   cursor before value k is start_bit + P_k, with P_k the sum of btr over
//   the values before k (in the sequence of the lane's valid values, then
//   the FALSE_STEREO pass's zeros).
// - The getbits counter has a closed form in P_k. A read refills bc by
//   the multiple of 8 that lifts it to >= btr (none if bc >= btr), then
//   takes btr; so bc_pre - btr == bc - btr (mod 8) at every read, and a
//   non-read leaves bc as it is: bc_k == S - P_k (mod 8), S = start_bc.
//   While S >= P_k no read has refilled (each read found bc = S - P_j >=
//   btr_j), so bc_k = S - P_k. The read that first takes P past S refills
//   (its bc < btr) and leaves bc in 0..7; from 0..7 a read leaves it in
//   0..7 again (bc - btr >= 0 without a refill, the refill's overshoot
//   below 8 with one). So bc_k = (S - P_k) mod 8 once S < P_k. One case
//   differs: S < 0 before any read, where bc_k = S and the closed form
//   gives S mod 8 = r; but with S = 8q + r both refill to the same bc_pre
//   (S + ceil8(btr - S) = r + ceil8(btr - r), which is r when btr <= r),
//   and the window and the next bc depend on bc_pre alone.
// - crc_x is affine in each value: crc <- 9 crc + g(v2) mod 2^32, and only
//   its final value is output. Over the lane's n valid values, crc_n =
//   9^n crc_0 + sum_k 9^(n-1-k) g_k.
//
// Design:
// - A warp per lane, a sample (its C values) per thread: 32 samples a
//   step, UNROLL steps a chunk. The warp scans the samples' bit counts
//   with shuffles (in 32 bits two steps share one scan, a step in each
//   16-bit half), carries each step's total to the next, and each thread
//   reads its values' windows at their own cursors (Stream::peek's two
//   words, through L1). No load waits on another value's read; a value's
//   work is branch-free (its window read even where it takes no bits), so
//   a chunk's loads and arithmetic interleave.
// - crc_x: thread i keeps h_i = sum over steps s of 9^(32 C (S-1-s)) q_s,
//   q_s its sample's C values in Horner form (0 past the count), over the
//   S steps the block runs (whole chunks). Then sum_i 9^(C (31-i)) h_i =
//   sum_k 9^(32CS-1-k) g_k, a warp sum once a lane; 9 is odd, so the
//   excess factor 9^(32CS - n) is undone with the inverse of 9 mod 2^32.
// - A block is WARPS adjacent lanes (the 1,584-lane bucket: 396 blocks,
//   three on each of the card's 132 SMs). Their samples move between
//   device memory and shared-memory tiles a chunk at a time, a lane's
//   sample per thread and access, so a warp reads and writes whole
//   32-byte sectors (stereo), where a warp reading its own lane's 32
//   samples would touch 32 sectors for 8 bytes each. The input tiles are
//   a ring of STAGES filled by cp.async, two chunks ahead of the scan.
// - After its scan a chunk prefetches into L1 the lines of the lane's
//   stream the next chunk will read, so its window loads hit.
// - A chunk whose samples are all below the lane's count (every chunk of
//   a full lane) runs without the per-value tests of the count.
// - The samples past the lane's count are copied unchanged, as the plain
//   version leaves them.
// The versions tried on the way to this design: PERF.md, section 6.
//
// 32-bit arithmetic, exact: sent_bits is a metadata byte (0..255,
// container/blockstate.py:239) and max_width is 0..31 (:259). Where
// sb <= 255, bit_length(pvalue) + sb <= 31 + 255 cannot overflow, and a
// truncated btr = mw - bit_length(pvalue) < sb; so 0 <= btr <= max(sb, 0)
// and the cursor stays below start_bit + n max(sb, 0) for a lane of n valid
// values. A lane with 0 <= start_bit and start_bit + n max(sb, 0) < 2^31
// (every staged lane: start_bit 0 or 5, n <= 3 T, sb <= 255 and T far
// below 2^21) runs the cursor, its prefix sums and the position clamp in
// int32. bc_k: S >= P_k gives S - P_k in 0..S; otherwise only its value
// mod 8 matters, taken from the 32-bit difference (8 divides 2^32); then
// bc_pre <= max(bc_k, btr + 7) < 2^31. The injected and re-expanded values
// are the plain version's int64 results truncated to 32 bits (wrap32):
// shifts by counts mod 32, or, add and subtract commute with reduction mod
// 2^32, and the window's low 32 bits are all a mask of sb & 31 < 32 bits
// keeps; crc_x is the same in uint32. Any other lane (sent_bits past a
// byte, a start_bit near 2^31) runs the same body on int64 cursors; the
// kernel counts such lanes (`wide`).

#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

using wvpk::cp_async;
using wvpk::cp_commit;

constexpr int WARPS = 4;   // adjacent lanes a block, a warp each
constexpr int UNROLL = 4;  // steps of 32 samples a chunk
constexpr int ROWS = 32 * UNROLL;  // samples a chunk
constexpr int STAGES = 3;          // input tiles in flight or in use
constexpr unsigned FULL = 0xFFFFFFFFu;

__host__ __device__ constexpr uint32_t power(uint32_t b, uint32_t e) {
  uint32_t r = 1;
  for (; e; e >>= 1, b *= b)
    if (e & 1) r *= b;
  return r;
}
template <int C>
constexpr uint32_t NINE_32C = power(9, 32 * C);  // a step's factor
constexpr uint32_t INV9 = 0x38E38E39u;  // 9 * INV9 == 1 mod 2^32
static_assert(9u * INV9 == 1u, "inverse of 9");

struct Args {
  const int *in, *nsamples;
  const uint32_t* words;
  const int *start_bit, *start_bc, *sent_bits, *max_width, *zod,
      *false_stereo;
  int *out, *crc_x, *wide;
  int L, W, T;
};

struct Lane {
  const uint32_t* words;
  int W, sb, mw, start_bit, start_bc;
  uint32_t mask;
  // the re-expansion: the arm's shift (mod 32) and what it adds before
  // the shift and takes away after it (1 for ones, the low bit for dups)
  int shift;
  bool add_one, add_odd;
};

// The bits value v takes from the stream; 0 where it reads none.
template <typename P>
__device__ __forceinline__ P bits_to_read(int v, const Lane& ln) {
  const int pv = v < 0 ? ~v : v;
  const P width = (P)(32 - __clz(pv)) + ln.sb;
  const bool trunc = ln.mw > 0 && width > ln.mw;
  const P btr = trunc ? (P)ln.sb - (width - ln.mw) : (P)ln.sb;
  return ln.sb > 0 && (!trunc || btr > 0) ? btr : (P)0;
}

// The low 32 bits of Stream::peek(bitpos): positions past the row's last
// word clamp to its start, the word after it is the 0xff EOF fill.
template <typename P>
__device__ __forceinline__ uint32_t window(const Lane& ln, P bitpos,
                                           P max_bit) {
  P bp = bitpos < max_bit ? bitpos : max_bit;
  // a negative start_bit is outside the domain (the plain version's
  // gather refuses it); the clamp keeps the load in the row
  bp = bp > 0 ? bp : (P)0;
  const int idx = (int)(bp >> 5);
  const uint32_t lo = __ldg(ln.words + idx);
  const uint32_t hi = __ldg(ln.words + min(idx + 1, ln.W - 1));
  return __funnelshift_r(lo, idx + 1 < ln.W ? hi : FULL, (int)bp & 31);
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l1(const uint32_t* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The re-expansion (UnpackUtils.cs:1316-1343), the lane's arm in one
// form: zeros v << z, ones ((v + 1) << o) - 1, dups ((v + odd) << d) - odd,
// none v (shift 0, nothing added).
__device__ __forceinline__ uint32_t expand(uint32_t v1, const Lane& ln) {
  const uint32_t add = (ln.add_odd ? v1 & 1u : 0u) | (uint32_t)ln.add_one;
  return ((v1 + add) << ln.shift) - add;
}

// A lane's sample (C values): one 8-byte access in stereo.
template <int C>
__device__ __forceinline__ void load_sample(const int* p, int (&v)[C]) {
  if constexpr (C == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void store_sample(int* p, const int (&v)[C]) {
  if constexpr (C == 2)
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  else
    *p = v[0];
}

// Inclusive warp scans of UNROLL steps' sums. In 32 bits (a lane of the
// proven range: a thread's sum <= 255 C, a step's <= 8,160 C < 2^16) two
// steps share a scan, one in each 16-bit half, as no carry crosses it.
template <typename P>
__device__ __forceinline__ void scan_steps(P (&x)[UNROLL], int i) {
  if constexpr (sizeof(P) == 4) {
#pragma unroll
    for (int u = 0; u < UNROLL; u += 2) {
      uint32_t y = (uint32_t)x[u] | ((uint32_t)x[u + 1] << 16);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t z = __shfl_up_sync(FULL, y, d);
        y += i >= d ? z : 0u;
      }
      x[u] = (P)(y & 0xFFFFu);
      x[u + 1] = (P)(y >> 16);
    }
  } else {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const P z = __shfl_up_sync(FULL, x[u], d);
        x[u] += i >= d ? z : (P)0;
      }
  }
}

// A tile row: the block's WARPS lanes' samples of one index, padded so
// that a warp's 32 rows fall in distinct banks.
template <int C>
constexpr int PITCH = WARPS * C + (C == 2 ? 2 : 1);

// One lane's scan state: the bits read so far and the per-thread crc_x
// sums (Horner over steps).
template <typename P>
struct Scan {
  P carry;
  uint32_t h;
};

// A chunk of ROWS samples of one lane, thread i taking sample j0 + 32 u +
// i of step u, from the lane's column of the tile `tin` into `tout`.
// Sample j < nt holds C values of the sequence; past nt the sequence goes
// on with the FALSE_STEREO pass's zeros (n values in all), and a sample
// nt <= j < T is copied unchanged. WHOLE: every sample of the chunk is
// below nt.
template <int C, typename P, bool WHOLE>
__device__ __forceinline__ void scan_chunk(Scan<P>& st, const int* tin,
                                           int* tout, const Lane& ln,
                                           int j0, int nt, int n, int i) {
  const P max_bit = sizeof(P) == 4
                        ? (P)min((long long)(ln.W - 1) * 32, 0x7FFFFFFFLL)
                        : (P)((long long)(ln.W - 1) * 32);
  int v[UNROLL][C];
  P b[UNROLL][C], incl[UNROLL], pos[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + 32 * u + i;
    load_sample<C>(tin + (32 * u + i) * PITCH<C>, v[u]);
    pos[u] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // past nt the sequence holds the FALSE_STEREO pass's zeros
      const P bk = bits_to_read<P>(WHOLE || j < nt ? v[u][c] : 0, ln);
      b[u][c] = WHOLE || j * C + c < n ? bk : (P)0;
      pos[u] += b[u][c];
    }
    incl[u] = pos[u];
  }
  scan_steps<P>(incl, i);
  const P carry0 = st.carry;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    pos[u] = st.carry + incl[u] - pos[u];  // P before the sample's values
    st.carry += __shfl_sync(FULL, incl[u], 31);
  }
  // The next chunk's words into L1 while this one is computed: the
  // 128-byte lines from its first bit on, one more than this chunk read.
  if ((P)i * 1024 <= st.carry - carry0 + 1024) {
    P wd = ((ln.start_bit + st.carry) >> 5) + 32 * i;
    wd = wd < ln.W - 1 ? wd : (P)(ln.W - 1);
    prefetch_l1(ln.words + (wd > 0 ? wd : (P)0));
  }
  // Each value without a branch: its window is read whether or not it
  // takes bits (a clamped position in the row), so the chunk's loads and
  // arithmetic interleave.
  const P s = ln.start_bc;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + 32 * u + i;
    int w[C];
    uint32_t q = 0;
    P p = pos[u];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const P bk = b[u][c];
      const uint32_t u32 = WHOLE || j < nt ? (uint32_t)v[u][c] : 0u;
      const P bc = s >= p ? s - p : (P)(((uint32_t)s - (uint32_t)p) & 7u);
      const P need = bk > bc ? bk - bc : (P)0;
      const P bc_pre = bc + (((need + 7) >> 3) << 3);
      const int nb = bc_pre < 32 ? (int)bc_pre : 32;  // 1..32 where bk > 0
      const uint32_t data = window<P>(ln, ln.start_bit + p, max_bit) &
                            (FULL >> ((32 - nb) & 31)) & ln.mask;
      const uint32_t v1 =
          bk > 0 ? ((u32 << ((int)bk & 31)) | data)
                       << (((uint32_t)ln.sb - (uint32_t)bk) & 31)
          : ln.sb > 0 ? u32 << (ln.sb & 31)
                      : u32;
      const uint32_t v2 = expand(v1, ln);
      w[c] = WHOLE || j < nt ? (int)v2 : v[u][c];
      q = q * 9u + (WHOLE || j * C + c < n ? 3u * (v2 & 0xFFFFu) + (v2 >> 16)
                                           : 0u);
      p += bk;
    }
    st.h = st.h * NINE_32C<C> + q;
    store_sample<C>(tout + (32 * u + i) * PITCH<C>, w);
  }
}

// The block's lanes' samples [t0, t0 + rows) of the (T, L, C) layout
// (rows `row` ints apart, from the block's first lane) and a tile, a
// lane's sample per thread and access: a warp covers 8 sample indices of
// 4 lanes, whole 32-byte sectors in stereo. `stage` queues the copies
// into a tile with cp.async as one commit group; `drain` writes a tile
// back.
template <int C>
struct TileRows {
  int t0, rows, lanes;
  __device__ __forceinline__ bool at(int k, int& r, int& l) const {
    const int x = threadIdx.x + k * 32 * WARPS;
    r = x / WARPS;
    l = x % WARPS;
    return r < rows && l < lanes;
  }
  __device__ __forceinline__ void stage(int* tile, const int* g,
                                        size_t row) const {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      int r, l;
      if (at(k, r, l))
        cp_async<4 * C>(tile + r * PITCH<C> + l * C,
                        g + (size_t)(t0 + r) * row + l * C);
    }
    cp_commit();
  }
  __device__ __forceinline__ void drain(const int* tile, int* g,
                                        size_t row) const {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      int r, l, v[C];
      if (at(k, r, l)) {
        load_sample<C>(tile + r * PITCH<C> + l * C, v);
        store_sample<C>(g + (size_t)(t0 + r) * row + l * C, v);
      }
    }
  }
};

template <int C>
__global__ void __launch_bounds__(32 * WARPS) wvx_kernel(Args a) {
  // a ring of STAGES input tiles (chunk ch in ch % STAGES) and the output
  // tile
  __shared__ __align__(16) int tin[STAGES][ROWS * PITCH<C>],
      tout[ROWS * PITCH<C>];
  const int i = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lane0 = blockIdx.x * WARPS, lane = lane0 + w;
  const int lanes = min(WARPS, a.L - lane0);
  const bool fs_on = a.false_stereo != nullptr;
  // the block runs as many chunks as its longest lane or its rows need
  int chunks = (a.T + ROWS - 1) / ROWS;
  for (int l = 0; l < lanes; ++l) {
    const int nt = min(max(a.nsamples[lane0 + l], 0), a.T);
    const int n = nt * C + (fs_on && a.false_stereo[lane0 + l] ? nt : 0);
    chunks = max(chunks, ((n + C - 1) / C + ROWS - 1) / ROWS);
  }
  Lane ln;
  int nt = 0, n = 0;
  bool narrow = true;
  if (w < lanes) {
    ln.words = a.words + (size_t)lane * a.W;
    ln.W = a.W;
    ln.sb = a.sent_bits[lane];
    ln.mw = a.max_width[lane];
    const int zeros = a.zod[lane * 3], ones = a.zod[lane * 3 + 1],
              dups = a.zod[lane * 3 + 2];
    ln.shift = (zeros ? zeros : ones ? ones : dups) & 31;
    ln.add_one = !zeros && ones;
    ln.add_odd = !zeros && !ones && dups;
    ln.start_bit = a.start_bit[lane];
    ln.start_bc = a.start_bc[lane];
    ln.mask = (1u << (ln.sb & 31)) - 1u;
    nt = min(max(a.nsamples[lane], 0), a.T);
    n = nt * C + (fs_on && a.false_stereo[lane] ? nt : 0);
    narrow = ln.start_bit >= 0 && ln.sb <= 255 &&
             (long long)ln.start_bit + (long long)n * max(ln.sb, 0) <
                 (1LL << 31);
  }
  const size_t row = (size_t)a.L * C;
  const int* in = a.in + (size_t)lane0 * C;
  int* out = a.out + (size_t)lane0 * C;
  Scan<int> s32{0, 0};
  Scan<long long> s64{0, 0};
  auto rows_of = [&](int ch) {
    return TileRows<C>{ch * ROWS, min(ROWS, a.T - ch * ROWS), lanes};
  };
  // chunks 0 .. STAGES-2 in flight before the first is scanned
#pragma unroll
  for (int ch = 0; ch < STAGES - 1; ++ch) rows_of(ch).stage(tin[ch], in, row);
  for (int ch = 0; ch < chunks; ++ch) {
    // queue chunk ch + STAGES - 1 (an empty group past the rows), then
    // wait for chunk ch: the groups of the next STAGES - 1 may be pending
    rows_of(ch + STAGES - 1).stage(tin[(ch + STAGES - 1) % STAGES], in, row);
    cp_wait<STAGES - 1>();
    __syncthreads();
    const int* t = tin[ch % STAGES];
    if (w < lanes) {
      if (narrow && (ch + 1) * ROWS <= nt)  // every sample of the chunk real
        scan_chunk<C, int, true>(s32, t + w * C, tout + w * C, ln, ch * ROWS,
                                 nt, n, i);
      else if (narrow)
        scan_chunk<C, int, false>(s32, t + w * C, tout + w * C, ln,
                                  ch * ROWS, nt, n, i);
      else
        scan_chunk<C, long long, false>(s64, t + w * C, tout + w * C, ln,
                                        ch * ROWS, nt, n, i);
    }
    __syncthreads();
    rows_of(ch).drain(tout, out, row);
  }
  if (w < lanes) {
    // crc_n = 9^n (-1) + sum_k 9^(n-1-k) g_k, from sum_i 9^(C (31-i)) h_i
    uint32_t x = (narrow ? s32.h : s64.h) * power(9, C * (31 - i));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
    if (i == 0) {
      a.crc_x[lane] =
          (int)(x * power(INV9, chunks * ROWS * C - n) - power(9, n));
      if (!narrow) atomicAdd(a.wide, 1);
    }
  }
}

}  // namespace

// in/out (T, L, C) int32; nsamples, start_bit, start_bc, sent_bits,
// max_width (L,) int32; wvx_words (L, W) u32; zod (L, 3) int32;
// false_stereo (L,) int32 or null; crc_x (L,) int32; wide (1,) int32, to
// which the launch adds its lanes run on int64 cursors. Returns the
// launch's CUDA error code.
extern "C" int wvpk_wvx_inject(const void* in, const void* nsamples,
                               const void* wvx_words, const void* start_bit,
                               const void* start_bc, const void* sent_bits,
                               const void* max_width, const void* zod,
                               const void* false_stereo, void* out,
                               void* crc_x, void* wide, int L, int W, int T,
                               int mono, void* stream) {
  Args a{(const int*)in,         (const int*)nsamples,
         (const uint32_t*)wvx_words, (const int*)start_bit,
         (const int*)start_bc,   (const int*)sent_bits,
         (const int*)max_width,  (const int*)zod,
         (const int*)false_stereo, (int*)out,
         (int*)crc_x,            (int*)wide,
         L,                      W,
         T};
  dim3 grid((L + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (mono)
    wvx_kernel<1><<<grid, block, 0, s>>>(a);
  else
    wvx_kernel<2><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}
