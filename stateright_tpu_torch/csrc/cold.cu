// K20: the cold tier's merge-join -- a wave's new keys against one sorted
// chunk of a cold run.
//
// Replaces stateright_tpu/tiered/engine.py:200 _tiered_programs: its query
// (:223-243, the unsigned minimum and maximum of the new keys, which the
// host uses to prune each cold run to the window that can hold them) and
// its probe (:245-263, a branchless lower bound per new lane over one
// sorted, padded chunk of the window, then an equality test), with fresh_of
// (:265-268, fresh = new & ~found) folded into the probe: a hit clears the
// lane's new byte in place, so after the last pass the mask is JAX's
// ``fresh``, which K3 then compacts.
//
// Keys are the 64-bit words (hi << 32) | lo, ordered as unsigned 64-bit
// integers (a key of 2**63 or above sorts last).  A lane's key is read from
// the wave's buffer at the lane itself (the claim path) or at origin[lane]
// (the sorted path's representative), so no query array is materialized.
// Chunks are padded with the all-ones key, which no fingerprint equals (the
// JAX engine relies on the same sentinel): a pad lane never matches, and a
// key present in the chunk always has fewer than chunk_len smaller
// elements, so capping the lower bound at chunk_len - 1 never hides a hit.
//
// Bound: the query is bytes (the new bytes and the new lanes' keys, read
// once).  The probe reads the same, plus the chunk, whose log2(chunk_len)
// dependent loads a lane mostly hit in L2 (a 256 KB chunk at the default
// 2**15 keys, 8 MB at 2**20): it is latency-bound.
// Design: one thread a lane in a grid-stride loop.  The query reduces
// within a warp by shuffles, then across the block in shared memory, and
// one thread a block does a 64-bit atomicMin and atomicMax.  The probe's
// search is branchless: pos advances by half or not at every step.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long lane_key(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ origin, int64_t j) {
  const int64_t o = origin != nullptr ? static_cast<int64_t>(origin[j]) : j;
  return (static_cast<unsigned long long>(__ldg(hi + o)) << 32) |
         __ldg(lo + o);
}

__global__ void query_kernel(const uint32_t* __restrict__ hi,
                             const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ origin,
                             const uint8_t* __restrict__ is_new, int64_t n,
                             unsigned long long* __restrict__ minmax) {
  unsigned long long mn = ~0ull;
  unsigned long long mx = 0ull;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    if (!is_new[j]) continue;
    const unsigned long long k = lane_key(hi, lo, origin, j);
    mn = k < mn ? k : mn;
    mx = k > mx ? k : mx;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long a = __shfl_down_sync(0xffffffffu, mn, d);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, mx, d);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  __shared__ unsigned long long warp_mn[kThreads / 32];
  __shared__ unsigned long long warp_mx[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_mn[warp] = mn;
    warp_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) {
      mn = warp_mn[k] < mn ? warp_mn[k] : mn;
      mx = warp_mx[k] > mx ? warp_mx[k] : mx;
    }
    if (mn != ~0ull) atomicMin(&minmax[0], mn);
    if (mx != 0ull) atomicMax(&minmax[1], mx);
  }
}

__global__ void probe_kernel(const uint32_t* __restrict__ hi,
                             const uint32_t* __restrict__ lo,
                             const uint32_t* __restrict__ origin,
                             uint8_t* __restrict__ is_new, int64_t n,
                             const unsigned long long* __restrict__ chunk,
                             int64_t chunk_len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    if (!is_new[j]) continue;
    const unsigned long long q = lane_key(hi, lo, origin, j);
    int64_t pos = 0;
    for (int64_t half = chunk_len >> 1; half > 0; half >>= 1) {
      const unsigned long long c = __ldg(chunk + pos + half - 1);
      pos += c < q ? half : 0;
    }
    if (__ldg(chunk + pos) == q) is_new[j] = 0;
  }
}

}  // namespace

// hi, lo: the buffer's key halves; origin: n lane -> buffer lane words, or
// null (the lane itself); is_new: n bytes; minmax: two 64-bit words, set
// here to (all-ones, 0) and then to the unsigned minimum and maximum key of
// the new lanes (left so when no lane is new).
extern "C" int sr_cold_query(const uint32_t* hi, const uint32_t* lo,
                             const uint32_t* origin, const uint8_t* is_new,
                             int64_t n, unsigned long long* minmax,
                             cudaStream_t stream) {
  cudaMemsetAsync(minmax, 0xFF, sizeof(unsigned long long), stream);
  cudaMemsetAsync(minmax + 1, 0, sizeof(unsigned long long), stream);
  if (n > 0) {
    query_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
        hi, lo, origin, is_new, n, minmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// chunk: chunk_len (a power of two) sorted 64-bit keys, padded with
// all-ones; clears is_new[j] where lane j's key is in the chunk.
extern "C" int sr_cold_probe(const uint32_t* hi, const uint32_t* lo,
                             const uint32_t* origin, uint8_t* is_new,
                             int64_t n, const unsigned long long* chunk,
                             int64_t chunk_len, cudaStream_t stream) {
  if (n > 0) {
    probe_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
        hi, lo, origin, is_new, n, chunk, chunk_len);
  }
  return static_cast<int>(cudaGetLastError());
}
