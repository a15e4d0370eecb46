// Staging a lane's per-step inputs ahead of its serial scan, shared by the
// decorrelation kernel (decorr.cu), the correction scan (wvc.cu) and the
// encode kernels (encode_invert.cu, encode_words.cu, encode_hybrid.cu):
// each thread copies its lane's next TILE steps into a double-buffered
// ring in shared memory with cp.async while it computes the current TILE,
// so a step reads shared memory instead of waiting on device memory.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>
#include <vector>

namespace wvpk {

constexpr int STAGE_LANES = 32;  // threads of a staging block, one a lane
constexpr int TILE = 32;         // steps of one staged tile

// cp.async of BYTES (4 or 8) from device to shared memory, its commit and
// the wait for every group but the newest.
template <int BYTES>
__device__ __forceinline__ void cp_async(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A block's staging ring: two tiles of TILE steps x STAGE_LANES lanes x C
// values of the main input, then as much for each of EXTRA more inputs
// (0, 1 or 2; a bool WVC reads as 0 or 1).
template <bool MONO, int EXTRA>
__host__ __device__ constexpr int ring_ints() {
  return (1 + EXTRA) * 2 * TILE * STAGE_LANES * (MONO ? 1 : 2);
}

// One thread's view of the ring: its lane's C values of a step sit at
// column threadIdx.x of each step row, and only this thread writes or
// reads them. Step t of the input is at in + t * row (C contiguous ints;
// cp.async needs them aligned to 4 C bytes), of the second input at
// cin + t * row and of the third at din + t * row.
template <bool MONO, int EXTRA>
struct Stage {
  static_assert(EXTRA >= 0 && EXTRA <= 2, "one to three inputs");
  static constexpr int C = MONO ? 1 : 2;
  static constexpr int ROW = STAGE_LANES * C;  // ints of one step row
  static constexpr int BUF = TILE * ROW;       // ints of one tile
  int* sm;
  const int* in;
  const int* cin;
  size_t row;
  int ns;
  const int* din;

  // Queue the copies of tile `k` (steps below ns) into buffer k & 1 as
  // one commit group.
  __device__ __forceinline__ void fetch(int k) {
    const int t0 = k * TILE;
    int* dst = sm + (k & 1) * BUF;
#pragma unroll 8
    for (int i = 0; i < TILE; ++i) {
      if (t0 + i < ns) {
        const size_t g = (size_t)(t0 + i) * row;
        cp_async<4 * C>(dst + i * ROW, in + g);
        if (EXTRA >= 1) cp_async<4 * C>(dst + 2 * BUF + i * ROW, cin + g);
        if (EXTRA >= 2) cp_async<4 * C>(dst + 4 * BUF + i * ROW, din + g);
      }
    }
    cp_commit();
  }

  // Before tile k's steps: queue tile k + 1 (an empty group after the
  // last), then wait for tile k. Tile 0 is fetched before the first call.
  __device__ __forceinline__ void advance(int k, int ntiles) {
    if (k + 1 < ntiles)
      fetch(k + 1);
    else
      cp_commit();  // an empty group: the wait below covers tile k
    cp_wait_all_but_newest();
  }

  // Step t's values (the second input's at + 2 * BUF, the third's at
  // + 4 * BUF); its tile has landed.
  __device__ __forceinline__ const int* at(int t) const {
    return sm + ((t / TILE) & 1) * BUF + (t % TILE) * ROW;
  }
};

// Launch `fn`, a kernel of STAGE_LANES-thread blocks whose static shared
// memory is its staging ring, as `blocks` blocks on `stream` of device
// `device` (encode_invert.cu, wvc.cu). Such a block needs little shared
// memory, and without a hint CUDA may size an SM's shared-memory
// carve-out for the most of them an SM can hold (228 KB), which leaves
// 28 KB of L1; these kernels read through L1 (the run-time invert's chain
// state in local memory, the bit reader's row). So the launch asks for a
// carve-out just large enough for the blocks that share an SM (blocks /
// SMs, rounded up), and the rest of the SM's 256 KB stays L1. The device's
// SM count and shared memory are read on its first launch, a kernel's
// static shared size on the kernel's first; the carve-out is set on a
// kernel's first launch and again only when a launch puts more blocks on
// an SM than it holds (it is never lowered), so launches of one width set
// it once. Past that, a launch makes no host API call but the launch.
// Returns the first CUDA error.
inline cudaError_t launch_staged(const void* fn, int blocks, int device,
                                 void** params, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  struct Device {
    int sms = 0, smem = 0;  // 0 until read
  };
  struct Kernel {
    const void* fn;
    int device, shared, held;  // held: the blocks an SM's carve-out holds
  };
  static std::mutex mu;
  static Device devices[MAX_DEVICES];
  static std::vector<Kernel> kernels;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    Device& d = devices[device];
    cudaError_t e = cudaSuccess;
    if (d.sms == 0) {
      int sms = 0, smem = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
      if (e != cudaSuccess) return e;
      d.sms = sms;
      d.smem = smem;
    }
    size_t k = 0;
    while (k < kernels.size() &&
           (kernels[k].fn != fn || kernels[k].device != device))
      ++k;
    if (k == kernels.size()) {
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, fn);
      if (e != cudaSuccess) return e;
      kernels.push_back({fn, device, (int)fa.sharedSizeBytes, 0});
    }
    Kernel& kn = kernels[k];
    const int per_sm = (blocks + d.sms - 1) / d.sms;
    if (per_sm > kn.held) {
      // 1 KB a block is the system's (cudaDevAttrReservedSharedMemoryPerBlock)
      const long long need = (long long)per_sm * (kn.shared + 1024);
      long long pct = (100 * need + d.smem - 1) / d.smem;
      pct = pct < 1 ? 1 : pct > 100 ? 100 : pct;
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout, (int)pct);
      if (e != cudaSuccess) return e;
      kn.held = per_sm;
    }
  }
  const cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(STAGE_LANES),
                                         params, 0, stream);
  if (e != cudaSuccess) cudaGetLastError();  // clear it: the caller raises
  return e;
}

}  // namespace wvpk
