// DSD mode-1 ("fast") decode for Hopper (sm_90a): one warp per lane, the
// lane's tables in shared memory.
//
// Replaces wvpk/ops/dsd_pallas.py::_dsd_fast_kernel. The semantics are
// those of wvpk/ops/dsd.py::dsd_fast_decode and of its port
// wvpk_torch/ops/dsd.py (the plain version): the byte-wise range decoder
// of DsdUtils.cs:244-304 over per-history-bin cumulative tables, with the
// mult == 0 interval reset (4 fresh bytes when 4 remain), the error
// conditions (an empty table, an index past the table), each of which
// stops the lane with err set and zero outputs after it, and the
// mono/stereo history rotation.
//
// What bounds it: each output byte's interval depends on the one before,
// so a lane is one serial chain of steps and the only parallelism is the
// lane count; the kernel is bound by the latency of a step, not by memory
// bandwidth (it reads each payload byte and table entry once and writes
// 1 byte an output).
//
// Design. A warp decodes one lane; its 32 threads hold the same coder
// state, so no thread diverges, and they share the step's table reads:
// - The prologue copies the lane's bins x 256 cumulative row from the
//   int32 tensor into shared memory as uint16 (entries are at most
//   255 x 256 = 65,280; the wrapper refuses a table with an entry outside
//   [0, 65535]). cp.async moves bytes unchanged, so it cannot narrow
//   int32 to uint16: the warp loads the words and stores the halves. A
//   block holds WARPS lanes (16 KB of table a lane at 32 bins), so a
//   696-lane group spreads over all 132 SMs.
// - The code is code = #{c : summed[c] <= index} over a nondecreasing
//   row, found in two ballot rounds instead of 8 dependent loads: thread i
//   tests entry 8i + 7, the popcount g counts the groups of 8 wholly at or
//   below the index; threads j < 8 test entry 8g + j, the popcount is the
//   rest. summed[code - 1] and summed[code] come from those reads by
//   shuffles. (Each thread holding its 8 entries of the row in registers,
//   one ballot round, measured slower: more instructions a step for no
//   shorter chain.)
// - No division. mult = (high - low) / summed[255] is a multiply by the
//   bin's magic number (below), made once a bin in the prologue. The index
//   is never formed: for mult >= 1 and integers r, x,
//   r <= floor(x / mult) <=> r * mult <= x, so the rank search compares
//   summed[c] * mult with x = value - low, and index >= summed[255] is
//   x >= summed[255] * mult. Every product is at most
//   summed[255] * mult <= high - low < 2^32, so none wraps. mult == 0 is
//   high - low < summed[255], known before the multiply; after the reset
//   mult = (2^32 - 1) / summed[255] >= 65,537, so the reference's second
//   zero-interval error cannot occur for a table the wrapper takes.
// - A step with an error (an empty row or an index past the table) is
//   computed like any other and stops the lane before it is committed, so
//   no branch waits on the error tests; every index a bad step makes stays
//   inside the lane's table.
// - The payload comes through dsd_window.cuh's warp window: each thread
//   holds one word of the next 32 and of the 32 after, so a refill is a
//   shuffle and no load is waited on.
//
// The division magic: for a divisor d in [1, 2^16) and m = floor(2^48 / d)
// + 1, floor(n m / 2^48) = floor(n / d) for every 0 <= n < 2^32. With
// n = q d + r, 0 <= r < d: 2^48 / d < m <= 2^48 / d + 1, so
// n m / 2^48 > n / d >= q, and n m / 2^48 <= n / d + n / 2^48
// < q + (d - 1) / d + 2^-16 < q + 1 because 2^-16 < 1 / d. m has at most
// 49 bits; with m = mh 2^32 + ml, floor(n m / 2^32) = n mh +
// umulhi(n, ml) (< 2^49), and its >> 16 is the quotient.

#include <cstdint>
#include <cuda_runtime.h>

#include "dsd_window.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // lanes a block, one warp each
constexpr int ROW = 256;  // entries of a history bin's cumulative row
// the shared memory a block may use after opting in (H100, H200)
constexpr int SMEM_OPTIN = 232448;

// Shared bytes of one lane: its bins' magic words, then the table.
__host__ __device__ constexpr int lane_bytes(int bins) {
  return bins * (16 + 2 * ROW);
}

// A bin's divisor d = summed[255] (0: an empty row) and its magic
// multiplier m = floor(2^48 / d) + 1: {ml, mh, d, 0}.
__device__ __forceinline__ uint4 make_magic(uint32_t d) {
  if (d == 0) return make_uint4(0, 0, 0, 0);
  const uint64_t m = (1ull << 48) / d + 1;
  return make_uint4((uint32_t)m, (uint32_t)(m >> 32), d, 0);
}

__device__ __forceinline__ uint32_t divide(uint32_t n, uint4 mg) {
  const uint64_t hi = (uint64_t)n * mg.y + __umulhi(n, mg.x);
  return (uint32_t)(hi >> 16);
}

template <bool MONO>
__global__ void __launch_bounds__(WARPS * 32)
dsd_fast_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ nbytes,
                const int* __restrict__ summed,
                const long long* __restrict__ value0,
                const int* __restrict__ nvals, uint8_t* __restrict__ out,
                int* __restrict__ err_out, int* __restrict__ crc_out, int L,
                int NB, int bins, int nsteps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lane >= L) return;  // whole warps: no block barrier below
  uint4* magic = reinterpret_cast<uint4*>(smem + warp * lane_bytes(bins));
  uint16_t* tab = reinterpret_cast<uint16_t*>(magic + bins);

  // prologue: the lane's table as uint16, and each bin's magic
  const int* src = summed + (size_t)lane * bins * ROW;
  const int n = bins * ROW;
#pragma unroll 16
  for (int i = lid; i < n; i += 32) tab[i] = (uint16_t)__ldg(src + i);
  for (int b = lid; b < bins; b += 32)
    magic[b] = make_magic((uint32_t)__ldg(src + b * ROW + ROW - 1));
  __syncwarp();

  dsd::Window<dsd::WarpWords> win;
  win.src.start(reinterpret_cast<const uint32_t*>(data + (size_t)lane * NB),
                NB / 4, lid);
  win.fill();
  // the lane's nsteps output bytes, written a 4-byte word at a time
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)lane * nsteps);
  uint32_t word = 0;
  const int nb = nbytes[lane];
  const int stop = nvals[lane] < nsteps ? nvals[lane] : nsteps;
  uint32_t value = (uint32_t)value0[lane], low = 0, high = FULL;
  uint32_t crc = FULL;
  int p0 = 0, p1 = 0, bptr = 0;
  bool err = false;
  // the step's bin: its magic and the tops of its 32 groups of 8 (in
  // stereo the next step's bin is known a step ahead and read then)
  uint4 mg = magic[0];
  uint32_t top8 = tab[8 * lid + 7];
  int t = 0;
  for (; t < stop; ++t) {
    uint4 mg_next = mg;
    uint32_t top8_next = top8;
    if (!MONO) {
      mg_next = magic[p1];
      top8_next = tab[p1 * ROW + 8 * lid + 7];
    }
    const uint16_t* r = tab + p0 * ROW;
    const uint32_t d = mg.z;
    uint32_t range = high - low, lo = low, val = value;
    int bp = bptr;
    if (range < d) {  // mult == 0: 4 fresh bytes if 4 remain, reset
      if (nb - bp >= 4) {
        val = win.consume(4);
        bp += 4;
      }
      lo = 0;
      range = FULL;
    }
    const uint32_t mult = divide(range, mg);
    const uint32_t x = val - lo;
    const bool bad = d == 0 || x >= d * mult;  // index >= summed[255]
    const int g = __popc(__ballot_sync(FULL, top8 * mult <= x)) & 31;
    const uint32_t e = r[8 * g + (lid & 7)];
    const int c = __popc(__ballot_sync(FULL, e * mult <= x) & 0xFFu);
    const int code = 8 * g + c;
    const uint32_t top = __shfl_sync(FULL, e, c & 31);
    uint32_t base = __shfl_sync(FULL, c ? e : top8, c ? c - 1 : (g - 1) & 31);
    if (bad) {
      err = true;
      break;
    }
    if (code == 0) base = 0;
    low = lo + base * mult;
    high = low + (top - base) * mult - 1;
    value = val;
    bptr = bp;
    dsd::renorm(high, low, value, bptr, win, nb);
    crc = crc * 3 + (uint32_t)code;
    const int hist = code & (bins - 1);
    if (MONO) {
      p0 = hist;
      mg = magic[p0];
      top8 = tab[p0 * ROW + 8 * lid + 7];
    } else {
      p0 = p1;
      p1 = hist;
      mg = mg_next;
      top8 = top8_next;
    }
    word |= (uint32_t)code << (8 * (t & 3));
    if ((t & 3) == 3) {
      if (lid == 0) orow[t >> 2] = word;
      word = 0;
    }
  }
  // the partial word, then zeros to the end of the row
  for (int w = (t >> 2) + lid; w < nsteps / 4; w += 32)
    orow[w] = w == (t >> 2) ? word : 0;
  if (lid == 0) {
    err_out[lane] = err ? 1 : 0;
    crc_out[lane] = (int)crc;
  }
}

template <bool MONO>
int launch(const uint8_t* d, const int* nb, const int* sm,
           const long long* v0, const int* nv, uint8_t* out, int* err,
           int* crc, int L, int NB, int bins, int nsteps, cudaStream_t s) {
  const int per_lane = lane_bytes(bins);
  int lanes = SMEM_OPTIN / per_lane;
  lanes = lanes < WARPS ? lanes : WARPS;
  const int smem = lanes * per_lane;
  cudaError_t e = cudaFuncSetAttribute(
      dsd_fast_kernel<MONO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dsd_fast_kernel<MONO><<<(L + lanes - 1) / lanes, lanes * 32, smem, s>>>(
      d, nb, sm, v0, nv, out, err, crc, L, NB, bins, nsteps);
  return (int)cudaGetLastError();
}

}  // namespace

// data (L, NB) uint8, NB a multiple of 4; nbytes, nvals (L,) int32, each
// nbytes at most NB; summed (L, bins * 256) int32, nondecreasing rows of
// entries in [0, 65535]; value0 (L,) int64 (the initial 32-bit window);
// out (L, nsteps) uint8, nsteps a multiple of 4; err, crc (L,) int32.
// Returns the launch's CUDA error code.
extern "C" int wvpk_dsd_fast_decode(const void* data, const void* nbytes,
                                    const void* summed, const void* value0,
                                    const void* nvals, void* out, void* err,
                                    void* crc, int L, int NB, int bins,
                                    int nsteps, int mono, void* stream) {
  if (bins < 1 || bins > 256 || (bins & (bins - 1)) != 0 || NB < 4 ||
      NB % 4 != 0 || nsteps % 4 != 0)
    return (int)cudaErrorInvalidValue;
  auto* fn = mono ? launch<true> : launch<false>;
  return fn((const uint8_t*)data, (const int*)nbytes, (const int*)summed,
            (const long long*)value0, (const int*)nvals, (uint8_t*)out,
            (int*)err, (int*)crc, L, NB, bins, nsteps, (cudaStream_t)stream);
}
