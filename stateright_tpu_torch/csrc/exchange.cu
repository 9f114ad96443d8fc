// K26: owner bucketing of a shard's representatives for the exchange.
//
// Replaces stateright_tpu/parallel/sharded.py:683-727 (the owner mix :97,
// the stable argsort of the owner keys, the n + 1 bucket counts, the
// in-bucket positions and the drop-mode scatter of the packed payload).
// For each representative lane i (valid[i] set):
//   owner  = fmix32(lo ^ rotl(hi, 7) ^ 0xA511E9B3) % n
//   rank   = the lanes before i, in lane order, with the same owner
//   send[owner][rank] = row, parent gid, ebits, 1      if rank < bkt
// where the row is rows[ridx[i]] and the parent is state olane[i] / a of
// the wave's chunk (its gid and eventually-bits).  Invalid lanes count
// under key n and are not sent.  counts[0..n] are the bucket sizes,
// overflow = 1 when a destination holds more than bkt representatives.
// Slots of a bucket past its count are written zero, so the whole
// [n, bkt, W + 3] send buffer is written once.  The rank in lane order is
// JAX's stable argsort: receive order decides which lane the owner's
// insert elects, and so which parents and paths result.
//
// Bound: bytes.  Each lane's key, validity and index words are read twice
// (count, then scatter) and its payload (row, gid, ebits) once; the send
// buffer is written once.
// Design: two launches.  (1) each block counts the owners of one tile of
// 2048 lanes in shared memory; (2) each block re-reads its tile, takes its
// offset in every bucket from the earlier tiles' counts, ranks its lanes
// with one block scan per destination (each thread owns 8 consecutive
// lanes, so the rank follows lane order), scatters the payload, and
// zero-fills its share of the unused bucket slots.  Block 0 writes the
// counts and the overflow bit.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__device__ __forceinline__ uint32_t owner_of(uint32_t hi, uint32_t lo,
                                             uint32_t n) {
  return sr::fmix32(lo ^ sr::rotl32(hi, 7) ^ 0xA511E9B3u) % n;
}

__global__ void tile_count_kernel(const uint32_t* __restrict__ hi,
                                  const uint32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ valid, int64_t u,
                                  uint32_t n, int64_t* __restrict__ tile_counts) {
  extern __shared__ unsigned int s_count[];  // n + 1
  for (uint32_t d = threadIdx.x; d <= n; d += blockDim.x) s_count[d] = 0;
  __syncthreads();
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < u) atomicAdd(&s_count[valid[i] ? owner_of(hi[i], lo[i], n) : n], 1u);
  }
  __syncthreads();
  for (uint32_t d = threadIdx.x; d <= n; d += blockDim.x) {
    tile_counts[static_cast<int64_t>(blockIdx.x) * (n + 1) + d] = s_count[d];
  }
}

__global__ void scatter_kernel(const uint32_t* __restrict__ hi,
                               const uint32_t* __restrict__ lo,
                               const uint8_t* __restrict__ valid, int64_t u,
                               const uint32_t* __restrict__ rows,
                               int64_t row_stride, int w,
                               const uint32_t* __restrict__ ridx,
                               const uint32_t* __restrict__ olane, int a,
                               const uint32_t* __restrict__ gids,
                               const uint32_t* __restrict__ ebs, uint32_t n,
                               int64_t bkt,
                               const int64_t* __restrict__ tile_counts,
                               int64_t ntiles, uint32_t* __restrict__ send,
                               int64_t* __restrict__ counts,
                               int* __restrict__ overflow) {
  extern __shared__ long long s_off[];  // [0, n]: this tile's offsets; then totals
  long long* s_tot = s_off + (n + 1);
  for (uint32_t d = threadIdx.x; d <= n; d += blockDim.x) {
    long long before = 0, all = 0;
    for (int64_t t = 0; t < ntiles; ++t) {
      const long long c = tile_counts[t * (n + 1) + d];
      if (t < blockIdx.x) before += c;
      all += c;
    }
    s_off[d] = before;
    s_tot[d] = all;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (uint32_t d = threadIdx.x; d <= n; d += blockDim.x) counts[d] = s_tot[d];
    if (threadIdx.x == 0) {
      int o = 0;
      for (uint32_t d = 0; d < n; ++d) o |= s_tot[d] > bkt ? 1 : 0;
      *overflow = o;
    }
  }
  const int row_words = w + 3;
  // Zero-fill this block's share of the slots past each bucket's count.
  const int64_t words = static_cast<int64_t>(n) * bkt * row_words;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < words; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t slot = j / row_words;
    if (slot % bkt >= s_tot[slot / bkt]) send[j] = 0u;
  }
  // Rank this tile's lanes within their buckets, in lane order.
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t dest[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    dest[k] = (i < u && valid[i]) ? owner_of(hi[i], lo[i], n) : n;
  }
  for (uint32_t d = 0; d < n; ++d) {
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) c += dest[k] == d ? 1u : 0u;
    uint32_t total;
    const uint32_t prefix =
        sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
    if (total == 0) continue;  // uniform over the block
    long long rank = s_off[d] + prefix;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dest[k] != d) continue;
      if (rank < bkt) {
        const int64_t i = base + k;
        uint32_t* out = send + (static_cast<int64_t>(d) * bkt + rank) * row_words;
        const uint32_t* row = rows + static_cast<int64_t>(ridx[i]) * row_stride;
        for (int c2 = 0; c2 < w; ++c2) out[c2] = row[c2];
        const uint32_t parent = olane[i] / static_cast<uint32_t>(a);
        out[w] = gids[parent];
        out[w + 1] = ebs[parent];
        out[w + 2] = 1u;
      }
      ++rank;
    }
  }
}

}  // namespace

// hi, lo: u key words; valid: u bytes; rows: 32-bit words, row r at
// rows + r * row_stride, w words each; ridx, olane: u words; gids, ebs:
// one word per state of the wave's chunk; send: n * bkt * (w + 3) words;
// counts: n + 1 int64; overflow: one int; tile_scratch: ceil(u / 2048) *
// (n + 1) int64 words.  n >= 1, bkt >= 1, a >= 1.
extern "C" int sr_owner_bucket(const uint32_t* hi, const uint32_t* lo,
                               const uint8_t* valid, int64_t u,
                               const uint32_t* rows, int64_t row_stride, int w,
                               const uint32_t* ridx, const uint32_t* olane,
                               int a, const uint32_t* gids, const uint32_t* ebs,
                               uint32_t n, int64_t bkt, uint32_t* send,
                               int64_t* counts, int* overflow,
                               int64_t* tile_scratch, cudaStream_t stream) {
  const int64_t ntiles = (u + kTile - 1) / kTile;
  if (ntiles > 0) {
    tile_count_kernel<<<static_cast<unsigned>(ntiles), kThreads,
                        (n + 1) * sizeof(unsigned int), stream>>>(
        hi, lo, valid, u, n, tile_scratch);
  }
  const int64_t zero_blocks =
      (static_cast<int64_t>(n) * bkt * (w + 3) + kThreads - 1) / kThreads;
  // A block per tile, and enough blocks for the zero-fill.
  int64_t blocks = zero_blocks < 132 * 8 ? zero_blocks : 132 * 8;
  if (blocks < ntiles) blocks = ntiles;
  if (blocks < 1) blocks = 1;
  scatter_kernel<<<static_cast<unsigned>(blocks), kThreads,
                   2 * (n + 1) * sizeof(long long), stream>>>(
      hi, lo, valid, u, rows, row_stride, w, ridx, olane, a, gids, ebs, n, bkt,
      tile_scratch, ntiles, send, counts, overflow);
  return static_cast<int>(cudaGetLastError());
}
