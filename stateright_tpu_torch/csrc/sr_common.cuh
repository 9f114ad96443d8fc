// Shared device helpers for the port's kernels: the murmur3-style 32-bit
// mixers of stateright_tpu/ops/device_fp.py (bit-exact), a block-wide scan,
// a one-block offsets scan, a warp's decoupled look-back over epoch-tagged
// status words (K26, K27), and the error-string export every library
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

// Decoupled look-back (Merrill and Garland, 2016) over 64-bit status words,
// one a tile (and key): a flag (the tile's own count, or the inclusive
// prefix through it), a 30-bit per-call epoch and a 32-bit value, read
// with one load.  The words are never cleared: a word of another epoch
// reads as unpublished.  Tiles are taken by ticket, in order, so a tile
// only ever waits on tiles already running.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's count
constexpr unsigned long long kInclusive = 2ull << 62;  // the prefix through it
constexpr unsigned long long kEpochMask = (1ull << 30) - 1;
constexpr int kLookBack = 4;  // status words a lane reads a step

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long flag, uint32_t epoch, uint32_t value) {
  return flag | ((static_cast<unsigned long long>(epoch) & kEpochMask) << 32) |
         value;
}

// Published in this call: a flag set and this call's epoch.
__device__ __forceinline__ bool published(unsigned long long w, uint32_t epoch) {
  return (w >> 62) != 0 &&
         ((w >> 32) & kEpochMask) == (static_cast<unsigned long long>(epoch) & kEpochMask);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// The sum of key d's values in the tiles before `tile` (one warp; status
// word of tile t and key d at status[t * n + d]): the lanes read the words
// of the 128 nearest tiles not yet added, and the warp adds them down to
// the nearest inclusive prefix; a word not yet published stops the step
// there and is read again.
__device__ inline uint32_t warp_look_back(const unsigned long long* status,
                                          int64_t tile, uint32_t n, uint32_t d,
                                          uint32_t epoch) {
  constexpr uint32_t kNone = 0xFFFFFFFFu;
  const uint32_t lane = threadIdx.x & 31;
  uint32_t excl = 0;
  int64_t j = tile - 1;  // the nearest tile not yet added
  for (;;) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int q = 0; q < kLookBack; ++q) {
      const int64_t t = j - static_cast<int64_t>(lane + 32 * q);
      // Before tile 0: an inclusive zero (tile 0's own word stops first).
      w[q] = t >= 0 ? load_status(status + t * n + d)
                    : status_word(kInclusive, epoch, 0);
    }
    uint32_t e_incl = kNone, e_wait = kNone;  // distances back from j
#pragma unroll
    for (int q = kLookBack - 1; q >= 0; --q) {
      const uint32_t e = lane + 32 * q;
      if (!published(w[q], epoch)) {
        e_wait = e;
      } else if (w[q] & kInclusive) {
        e_incl = e;
      }
    }
    e_incl = __reduce_min_sync(0xFFFFFFFFu, e_incl);
    e_wait = __reduce_min_sync(0xFFFFFFFFu, e_wait);
    const bool done = e_incl < e_wait;
    const uint32_t stop =
        done ? e_incl + 1 : (e_wait == kNone ? 32 * kLookBack : e_wait);
    uint32_t s = 0;
#pragma unroll
    for (int q = 0; q < kLookBack; ++q) {
      if (lane + 32 * q < stop) s += static_cast<uint32_t>(w[q]);
    }
    excl += __reduce_add_sync(0xFFFFFFFFu, s);
    if (done) return excl;
    if (stop == 0) __nanosleep(32);
    j -= stop;
  }
}

}  // namespace sr

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
