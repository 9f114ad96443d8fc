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
// once).  So is the probe on paper (the mask, the new lanes' keys, one
// byte a hit, the chunk once); in practice it is dependent 32-byte sector
// reads out of L2: the top levels of every lane's lower bound are shared
// (L1 or shared memory serves them), but the bottom ten or so of a
// 2**20-key chunk land each in its own sector.
// Design (probe): one thread a lane in a grid-stride loop over at most
// 1,056 blocks of 256 threads, which the card schedules as SMs free up, so
// the work balances itself even where a wave's new lanes cluster.
// Each block first copies the last key of each of S = 64 windows of the
// chunk into shared memory (the index is paid once a block, and L1 already
// holds the top levels every lane shares, so a small one is enough).  A
// new lane whose key lies outside the chunk's first and last key stops
// there; the others find their window in shared memory and finish with a
// branchless lower bound inside it (C/S keys), capped at its last key,
// then an equality test.  Designs
// that read the mask 16 bytes a thread (a block-wide list of new lanes; a
// list a warp; a two-phase kernel that compacts the lanes in range, then
// searches them from a 32 KB index; several lanes a thread searched side
// by side) were tried on the captured waves: each left too few threads
// searching, or waited on its slowest block, and was slower than this one.
// The query: one thread a lane in a grid-stride loop, reduced within a
// warp by shuffles, then across the block in shared memory, and one thread
// a block does a 64-bit atomicMin and atomicMax.
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

constexpr int kIndexKeys = 64;  // 512 bytes of shared memory a block
constexpr unsigned kProbeBlocks = 132 * 8;

__global__ void __launch_bounds__(kThreads) probe_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint32_t* __restrict__ origin, uint8_t* __restrict__ is_new,
    int64_t n, const unsigned long long* __restrict__ chunk, int s,
    int64_t step) {
  // The last key of each of the chunk's s windows of `step` keys.
  __shared__ unsigned long long idx[kIndexKeys];
  for (int i = threadIdx.x; i < s; i += kThreads)
    idx[i] = __ldg(chunk + static_cast<int64_t>(i) * step + step - 1);
  __syncthreads();
  // A key below the chunk's first or above its last is not in it.
  const unsigned long long first_key = __ldg(chunk);
  const unsigned long long last_key = idx[s - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n; j += stride) {
    if (!is_new[j]) continue;
    const unsigned long long q = lane_key(hi, lo, origin, j);
    if (q < first_key || q > last_key) continue;
    // The window: the first whose last key is not below q, found in shared
    // memory; then the lower bound inside it, capped at its last key.
    int g = 0;
    for (int half = s >> 1; half > 0; half >>= 1) g += idx[g + half - 1] < q ? half : 0;
    const unsigned long long* win = chunk + static_cast<int64_t>(g) * step;
    int64_t pos = 0;
    for (int64_t half = step >> 1; half > 0; half >>= 1)
      pos += __ldg(win + pos + half - 1) < q ? half : 0;
    if (__ldg(win + pos) == q) is_new[j] = 0;
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
    const int64_t s = chunk_len < kIndexKeys ? chunk_len : kIndexKeys;
    unsigned blocks = sr::grid_for(n, kThreads);
    if (blocks > kProbeBlocks) blocks = kProbeBlocks;
    probe_kernel<<<blocks, kThreads, 0, stream>>>(hi, lo, origin, is_new, n, chunk,
                                                  static_cast<int>(s), chunk_len / s);
  }
  return static_cast<int>(cudaGetLastError());
}
