// Staging a lane's per-step inputs ahead of its serial scan, shared by the
// decorrelation kernel (decorr.cu) and the encode word coders
// (encode_words.cu, encode_hybrid.cu): each thread copies its lane's next
// TILE steps into a double-buffered ring in shared memory with cp.async
// while it computes the current TILE, so a step reads shared memory
// instead of waiting on device memory.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

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
// values of the main input, then as much for a second input with WVC.
template <bool MONO, bool WVC>
__host__ __device__ constexpr int ring_ints() {
  return (WVC ? 2 : 1) * 2 * TILE * STAGE_LANES * (MONO ? 1 : 2);
}

// One thread's view of the ring: its lane's C values of a step sit at
// column threadIdx.x of each step row, and only this thread writes or
// reads them. Step t of the input is at in + t * row (C contiguous ints;
// cp.async needs them aligned to 4 C bytes), of the second input at
// cin + t * row.
template <bool MONO, bool WVC>
struct Stage {
  static constexpr int C = MONO ? 1 : 2;
  static constexpr int ROW = STAGE_LANES * C;  // ints of one step row
  static constexpr int BUF = TILE * ROW;       // ints of one tile
  int* sm;
  const int* in;
  const int* cin;
  size_t row;
  int ns;

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
        if (WVC) cp_async<4 * C>(dst + 2 * BUF + i * ROW, cin + g);
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

  // Step t's values (the second input's at + 2 * BUF); its tile has
  // landed.
  __device__ __forceinline__ const int* at(int t) const {
    return sm + ((t / TILE) & 1) * BUF + (t % TILE) * ROW;
  }
};

}  // namespace wvpk
