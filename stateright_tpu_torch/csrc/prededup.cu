// K12: the stable key sort of the sorted dedup fallback.
//
// Replaces the jax.lax.sort([shi, slo, lane], num_keys=2, is_stable=True)
// of stateright_tpu/parallel/hashset.py:232 prededup (the first stage of
// :282 insert_batch_compact and :449 insert_batch) and its representative
// test: lanes are sorted by the unsigned 64-bit key hi:lo, inactive lanes
// carrying the all-ones sentinel so they sort last, ties kept in lane
// order; then rep[i] marks the first lane of each run of equal keys whose
// key is not all-ones -- any all-ones key counts as inactive, as JAX's
// act_s does.  The input is in lane order and the sort is stable, so the
// first lane of a run is the run's LOWEST lane: the representative JAX
// elects.  The wrapper compacts the representatives with K3 and gathers
// their keys and lanes in sorted-key order.
//
// Bound: bytes.  Eight passes each read the 12-byte (key, lane) pair of
// every lane twice (histogram, scatter) and write it once, about 24 bytes
// a lane a pass once the histogram's read hits L2; the digit arithmetic
// is a few operations a lane.
// Design: an LSD radix sort, 8 passes of 8 bits from the low digit up, in
// two ping-pong buffers (an even pass count leaves the result where the
// load put it).  A pass is three launches: (1) each block counts its
// 4,096-lane tile's digits into a shared 256-bin histogram and writes it
// digit-major, counts[digit * tiles + tile]; (2) one block scans that
// array into exclusive offsets (sr::offsets_scan_kernel): the offset of
// (digit d, tile t) is the lanes of digits below d plus those of digit d
// in tiles before t, which is what makes the pass stable across tiles;
// (3) each block re-reads its tile in 16 rounds of 256 lanes, lane order
// within a round following thread order.  In a round each warp groups its
// equal digits with __match_any_sync -- a lane's rank in its group is the
// set bits of its group below it -- and its group leaders post the group
// sizes per warp; a lane's slot is its tile offset plus the digit's count
// in earlier rounds plus its count in earlier warps plus its rank, so the
// scatter is stable within a tile too.  The sort moves the 64-bit key and
// the 32-bit lane and nothing else.  No library sort is used.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;  // also the digit count: thread d owns digit d
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;
constexpr int kDigits = 256;
constexpr unsigned long long kOnes = ~0ull;

__global__ void load_kernel(const uint32_t* __restrict__ hi,
                            const uint32_t* __restrict__ lo,
                            const uint8_t* __restrict__ active, int64_t n,
                            unsigned long long* __restrict__ keys,
                            uint32_t* __restrict__ lanes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    keys[i] = active[i]
                  ? (static_cast<unsigned long long>(hi[i]) << 32) | lo[i]
                  : kOnes;
    lanes[i] = static_cast<uint32_t>(i);
  }
}

__global__ void histogram_kernel(const unsigned long long* __restrict__ keys,
                                 int64_t n, int shift, int64_t tiles,
                                 int64_t* __restrict__ counts) {
  __shared__ uint32_t hist[kDigits];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&hist[(keys[i] >> shift) & 0xFF], 1u);
  }
  __syncthreads();
  counts[threadIdx.x * tiles + blockIdx.x] = hist[threadIdx.x];
}

__global__ void scatter_kernel(const unsigned long long* __restrict__ keys_in,
                               const uint32_t* __restrict__ lanes_in,
                               int64_t n, int shift, int64_t tiles,
                               const int64_t* __restrict__ offsets,
                               unsigned long long* __restrict__ keys_out,
                               uint32_t* __restrict__ lanes_out) {
  __shared__ int64_t next[kDigits];            // the digit's next slot
  __shared__ uint32_t per_warp[kWarps][kDigits];  // this round's group sizes
  const int d = threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  next[d] = offsets[static_cast<int64_t>(d) * tiles + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) per_warp[w][d] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    const bool live = i < n;
    const unsigned long long key = live ? keys_in[i] : 0ull;
    // Lanes past n form a group of their own (digit 256) and move nothing.
    const int digit = live ? static_cast<int>((key >> shift) & 0xFF) : kDigits;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, digit);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (live && rank == 0) per_warp[warp][digit] = __popc(peers);
    __syncthreads();
    if (live) {
      int64_t slot = next[digit] + rank;
      for (int w = 0; w < warp; ++w) slot += per_warp[w][digit];
      keys_out[slot] = key;
      lanes_out[slot] = lanes_in[i];
    }
    __syncthreads();
    uint32_t used = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      used += per_warp[w][d];
      per_warp[w][d] = 0;
    }
    next[d] += used;
    __syncthreads();
  }
}

__global__ void rep_kernel(const unsigned long long* __restrict__ keys,
                           int64_t n, uint8_t* __restrict__ rep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const unsigned long long k = keys[i];
    rep[i] = (k != kOnes && (i == 0 || keys[i - 1] != k)) ? 1 : 0;
  }
}

}  // namespace

// hi, lo: n key words; active: n bytes.  keys, keys_tmp: n 64-bit words;
// lanes, lanes_tmp: n words; counts: 256 * ceil(n / 4096) int64 words of
// scratch.  Writes keys/lanes in sorted order (inactive lanes last, as the
// all-ones key) and rep: n bytes, the sorted lanes that represent a key.
extern "C" int sr_prededup_sort(const uint32_t* hi, const uint32_t* lo,
                                const uint8_t* active, int64_t n,
                                unsigned long long* keys,
                                unsigned long long* keys_tmp, uint32_t* lanes,
                                uint32_t* lanes_tmp, int64_t* counts,
                                uint8_t* rep, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const unsigned grid = sr::grid_for(n, kThreads);
  load_kernel<<<grid, kThreads, 0, stream>>>(hi, lo, active, n, keys, lanes);
  unsigned long long* src_k = keys;
  unsigned long long* dst_k = keys_tmp;
  uint32_t* src_l = lanes;
  uint32_t* dst_l = lanes_tmp;
  for (int shift = 0; shift < 64; shift += 8) {
    histogram_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        src_k, n, shift, tiles, counts);
    sr::offsets_scan_kernel<<<1, sr::kScanThreads, 0, stream>>>(
        counts, kDigits * tiles, nullptr);
    scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        src_k, src_l, n, shift, tiles, counts, dst_k, dst_l);
    unsigned long long* tk = src_k;
    src_k = dst_k;
    dst_k = tk;
    uint32_t* tl = src_l;
    src_l = dst_l;
    dst_l = tl;
  }
  rep_kernel<<<grid, kThreads, 0, stream>>>(keys, n, rep);
  return static_cast<int>(cudaGetLastError());
}
