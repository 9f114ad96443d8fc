// Shared device helpers for the port's kernels: the murmur3-style 32-bit
// mixers of stateright_tpu/ops/device_fp.py (bit-exact), a block-wide scan,
// a one-block offsets scan, and the error-string export every library
// carries for its ctypes wrapper.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sr {

constexpr uint32_t SEED_HI = 0x9E3779B9u;
constexpr uint32_t SEED_LO = 0x85EBCA6Bu;
constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix32(uint32_t h, uint32_t w) {
  uint32_t k = w * C1;
  k = rotl32(k, 15);
  k *= C2;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Blocks for a grid-stride loop over n items: enough to fill 132 SMs many
// times over, never more than the items need.
inline unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// Exclusive scan of one value per thread over a block of THREADS threads
// (a multiple of 32, at most 1024).  Returns this thread's exclusive
// prefix and writes the block total to *total (every thread sees it).
template <int THREADS, typename T>
__device__ __forceinline__ T block_exclusive_scan(T x, T* total) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block shape");
  __shared__ T warp_sums[THREADS / 32];
  __shared__ T block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < THREADS / 32 ? warp_sums[lane] : T(0);
    T winc = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T y = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = winc - w;
    if (lane == THREADS / 32 - 1) block_total = winc;
  }
  __syncthreads();
  *total = block_total;
  return warp_sums[warp] + inc - x;
}

constexpr int kScanThreads = 1024;

// One block of kScanThreads, in place: counts[0..n) -> their exclusive
// prefix sums (64-bit); *total = the sum of all counts.  Each thread sums
// a contiguous run serially, the block scans the runs, and each thread
// writes its run's offsets.
__global__ void offsets_scan_kernel(int64_t* __restrict__ counts, int64_t n,
                                    int64_t* __restrict__ total) {
  const int64_t per = (n + kScanThreads - 1) / kScanThreads;
  const int64_t lo = threadIdx.x * per;
  const int64_t hi = lo + per < n ? lo + per : n;
  unsigned long long s = 0;
  for (int64_t i = lo; i < hi; ++i) s += static_cast<unsigned long long>(counts[i]);
  unsigned long long all;
  unsigned long long run =
      block_exclusive_scan<kScanThreads, unsigned long long>(s, &all);
  for (int64_t i = lo; i < hi; ++i) {
    const unsigned long long c = static_cast<unsigned long long>(counts[i]);
    counts[i] = static_cast<int64_t>(run);
    run += c;
  }
  if (threadIdx.x == 0 && total != nullptr) *total = static_cast<int64_t>(all);
}

}  // namespace sr

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
