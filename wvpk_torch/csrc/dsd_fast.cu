// DSD mode-1 ("fast") decode for Hopper (sm_90a): one thread per lane.
//
// Replaces wvpk/ops/dsd_pallas.py::_dsd_fast_kernel. The semantics are
// those of wvpk/ops/dsd.py::dsd_fast_decode and of its port
// wvpk_torch/ops/dsd.py (the plain version): the byte-wise range decoder
// of DsdUtils.cs:244-304 over per-history-bin cumulative tables, with the
// mult == 0 interval reset (4 fresh bytes when 4 remain), the three error
// conditions (empty table, zero interval, index past the table), each of
// which stops the lane with err set and zero outputs after it, and the
// mono/stereo history rotation.
//
// What bounds it: each output byte's interval depends on the one before,
// so a lane is one serial scan and the only parallelism is the lane count
// (~700 lanes a group in the bench shape: 22 warps). The kernel is bound by
// the latency of each step's dependent chain (two 32-bit divisions, the
// table search, the renormalisation), not by memory bandwidth: it reads
// each payload byte once, each table row it visits from L1/L2, and writes
// 1 byte per output, four at a time into the lane's row of the delivered
// bytes (no separate pack).
//
// Design: the TPU kernel's workarounds are gone. `mult` and `index` are
// two uint32 divisions as CUDA compiles them, not 32-step long
// divisions; the bytes are read from the lane's uint8 row, not from a
// 32-word group cache; the code is found by a binary rank search of 8
// dependent loads on the bin's 256-entry cumulative row in device memory
// (code = #{c : summed[c] <= index}), which with summed[code - 1] and
// summed[code] replaces the reference's probability and lookup tables,
// so only `summed` is staged; renormalisation is the closed form
// min(clz(high ^ low) >> 3, bytes left) with one 4-byte fetch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;

// Bytes row[pos..pos+3] as one big-endian word, positions clamped into the
// row (bytes past the payload are never used: the caller takes at most the
// bytes left).
__device__ __forceinline__ uint32_t be4(const uint8_t* row, int cap,
                                        int pos) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i) {
    int p = pos + i < cap ? pos + i : cap - 1;
    v = (v << 8) | row[p];
  }
  return v;
}

// The reference's loop `while (((high ^ low) & 0xFF000000) == 0 && bytes
// left)` runs exactly clz(high ^ low) >> 3 times (each pass lowers the clz
// by 8), at most the bytes left.
__device__ __forceinline__ void renorm(uint32_t& high, uint32_t& low,
                                       uint32_t& value, int& bptr,
                                       const uint8_t* row, int cap,
                                       int nbytes) {
  int k = __clz((int)(high ^ low)) >> 3;
  int left = nbytes - bptr;
  left = left < 0 ? 0 : (left > 4 ? 4 : left);
  if (k > left) k = left;
  if (k == 0) return;
  uint32_t w = be4(row, cap, bptr);
  if (k == 4) {
    value = w;
    high = 0xFFFFFFFFu;
    low = 0;
  } else {
    int sh = 8 * k;
    value = (value << sh) | (w >> (32 - sh));
    high = (high << sh) | ((1u << sh) - 1);
    low <<= sh;
  }
  bptr += k;
}

template <bool MONO>
__global__ void __launch_bounds__(THREADS)
dsd_fast_kernel(const uint8_t* __restrict__ data,
                const int* __restrict__ nbytes,
                const int* __restrict__ summed,
                const long long* __restrict__ value0,
                const int* __restrict__ nvals, uint8_t* __restrict__ out,
                int* __restrict__ err_out, int* __restrict__ crc_out, int L,
                int NB, int bins, int nsteps) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint8_t* row = data + (size_t)lane * NB;
  // the lane's nsteps output bytes, written a 4-byte word at a time
  uint32_t* orow = reinterpret_cast<uint32_t*>(out + (size_t)lane * nsteps);
  uint32_t word = 0;
  const int* tab = summed + (size_t)lane * bins * 256;
  const int nb = nbytes[lane];
  const int stop = nvals[lane] < nsteps ? nvals[lane] : nsteps;
  uint32_t value = (uint32_t)value0[lane], low = 0, high = 0xFFFFFFFFu;
  uint32_t crc = 0xFFFFFFFFu;
  int p0 = 0, p1 = 0, bptr = 0;
  bool err = false;
  int t = 0;
  for (; t < stop; ++t) {
    const int* r = tab + p0 * 256;
    const uint32_t sp255 = (uint32_t)r[255];
    if (sp255 == 0) {
      err = true;
      break;
    }
    uint32_t mult = (high - low) / sp255;
    if (mult == 0) {
      if (nb - bptr >= 4) {
        value = be4(row, NB, bptr);
        bptr += 4;
      }
      low = 0;
      high = 0xFFFFFFFFu;
      mult = high / sp255;
      if (mult == 0) {
        err = true;
        break;
      }
    }
    const uint32_t index = (value - low) / mult;
    if (index >= sp255) {
      err = true;
      break;
    }
    int code = 0;
    for (int step = 128; step > 0; step >>= 1)
      if ((uint32_t)r[code + step - 1] <= index) code += step;
    const uint32_t base = code > 0 ? (uint32_t)r[code - 1] : 0u;
    const uint32_t top = (uint32_t)r[code];
    low += base * mult;
    high = low + (top - base) * mult - 1;
    renorm(high, low, value, bptr, row, NB, nb);
    crc = crc * 3 + (uint32_t)code;
    const int hist = code & (bins - 1);
    if (MONO) {
      p0 = hist;
    } else {
      p0 = p1;
      p1 = hist;
    }
    word |= (uint32_t)code << (8 * (t & 3));
    if ((t & 3) == 3) {
      orow[t >> 2] = word;
      word = 0;
    }
  }
  // the partial word, then zeros to the end of the row
  for (int w = t >> 2; w < nsteps / 4; ++w) {
    orow[w] = word;
    word = 0;
  }
  err_out[lane] = err ? 1 : 0;
  crc_out[lane] = (int)crc;
}

}  // namespace

// data (L, NB) uint8; nbytes, nvals (L,) int32; summed (L, bins * 256)
// int32; value0 (L,) int64 (the initial 32-bit window); out (L, nsteps)
// uint8, nsteps a multiple of 4; err, crc (L,) int32. Returns the launch's
// CUDA error code.
extern "C" int wvpk_dsd_fast_decode(const void* data, const void* nbytes,
                                    const void* summed, const void* value0,
                                    const void* nvals, void* out, void* err,
                                    void* crc, int L, int NB, int bins,
                                    int nsteps, int mono, void* stream) {
  if (bins < 1 || bins > 256 || (bins & (bins - 1)) != 0 || NB < 1 ||
      nsteps % 4 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + THREADS - 1) / THREADS), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  auto* d = (const uint8_t*)data;
  auto* nb = (const int*)nbytes;
  auto* sm = (const int*)summed;
  auto* v0 = (const long long*)value0;
  auto* nv = (const int*)nvals;
  if (mono)
    dsd_fast_kernel<true><<<grid, block, 0, s>>>(
        d, nb, sm, v0, nv, (uint8_t*)out, (int*)err, (int*)crc, L, NB,
        bins, nsteps);
  else
    dsd_fast_kernel<false><<<grid, block, 0, s>>>(
        d, nb, sm, v0, nv, (uint8_t*)out, (int*)err, (int*)crc, L, NB,
        bins, nsteps);
  return (int)cudaGetLastError();
}
