// K27: a shard's commit of the insert's new lanes.
//
// Replaces stateright_tpu/parallel/sharded.py:789-806 (the slot-indexed
// scatters of store, parent and ebits, and the queue append at tail through
// the cumsum of the new mask) and the seed's :1062-1068.  For the j-th new
// lane i in lane order:
//   store[slot[i]]  = rows[r]          (w words)
//   parent[slot[i]] = gid[r]
//   ebits[slot[i]]  = eb[r]
//   queue[tail + j] = slot[i]          (dropped past the queue's end)
// with r = origin[i] (the sorted path's representative -> receive lane),
// or i.  n_new = the count of new lanes.  The queue is FIFO in the order
// the insert saw its lanes, which is the BFS order of the shard.
//
// Bound: bytes.  The new mask is read twice (one byte a lane); each new
// state's slot, row, gid and ebits are read once, its row, parent and ebits
// written once at its slot and its queue entry once.
// Design: two launches, the compaction of K3 fused with the scatter.  (1)
// each block counts the new lanes of a tile of 2048; (2) each block sums the
// earlier tiles' counts, ranks its lanes with one block scan (each thread
// owns 8 consecutive lanes, so the rank is lane order), and writes each new
// lane's state at its slot and its slot at the queue position; block 0
// writes n_new.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void tile_count_kernel(const uint8_t* __restrict__ is_new,
                                  int64_t r, int64_t* __restrict__ tile_counts) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < r && is_new[i]) ++c;
  }
  uint32_t total;
  sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void commit_kernel(const uint8_t* __restrict__ is_new, int64_t r,
                              const uint32_t* __restrict__ slot,
                              const uint32_t* __restrict__ origin,
                              const uint32_t* __restrict__ rows,
                              int64_t row_stride, int w,
                              const uint32_t* __restrict__ gid,
                              int64_t gid_stride,
                              const uint32_t* __restrict__ eb,
                              int64_t eb_stride, uint32_t* __restrict__ store,
                              uint32_t* __restrict__ parent,
                              uint32_t* __restrict__ ebits,
                              uint32_t* __restrict__ queue, int64_t qlen,
                              int64_t tail,
                              const int64_t* __restrict__ tile_counts,
                              int64_t ntiles, int64_t* __restrict__ n_new) {
  unsigned long long before = 0, all = 0;
  for (int64_t t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const unsigned long long c = static_cast<unsigned long long>(tile_counts[t]);
    if (t < blockIdx.x) before += c;
    all += c;
  }
  unsigned long long sum;
  sr::block_exclusive_scan<kThreads, unsigned long long>(before, &sum);
  const unsigned long long offset = sum;
  sr::block_exclusive_scan<kThreads, unsigned long long>(all, &sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) *n_new = static_cast<int64_t>(sum);

  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool keep[kItems];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    keep[k] = i < r && is_new[i];
    c += keep[k] ? 1u : 0u;
  }
  uint32_t total;
  const uint32_t prefix = sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
  int64_t pos = tail + static_cast<int64_t>(offset) + prefix;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!keep[k]) continue;
    const int64_t i = base + k;
    const uint32_t s = slot[i];
    const int64_t src = origin != nullptr ? origin[i] : i;
    const uint32_t* row = rows + src * row_stride;
    uint32_t* dst = store + static_cast<int64_t>(s) * w;
    for (int c2 = 0; c2 < w; ++c2) dst[c2] = row[c2];
    parent[s] = gid[src * gid_stride];
    ebits[s] = eb[src * eb_stride];
    if (pos < qlen) queue[pos] = s;
    ++pos;
  }
}

}  // namespace

// is_new: r bytes; slot: r words (the key's table slot on new lanes);
// origin: r words or null; rows: row q at rows + q * row_stride, w words;
// gid, eb: word q at gid + q * gid_stride (eb likewise); store: capacity *
// w words; parent, ebits: capacity words; queue: qlen words; n_new: one
// int64; tile_scratch: max(1, ceil(r / 2048)) int64 words.
extern "C" int sr_shard_commit(const uint8_t* is_new, int64_t r,
                               const uint32_t* slot, const uint32_t* origin,
                               const uint32_t* rows, int64_t row_stride, int w,
                               const uint32_t* gid, int64_t gid_stride,
                               const uint32_t* eb, int64_t eb_stride,
                               uint32_t* store, uint32_t* parent,
                               uint32_t* ebits, uint32_t* queue, int64_t qlen,
                               int64_t tail, int64_t* n_new,
                               int64_t* tile_scratch, cudaStream_t stream) {
  int64_t ntiles = (r + kTile - 1) / kTile;
  if (ntiles < 1) ntiles = 1;
  tile_count_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      is_new, r, tile_scratch);
  commit_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      is_new, r, slot, origin, rows, row_stride, w, gid, gid_stride, eb,
      eb_stride, store, parent, ebits, queue, qlen, tail, tile_scratch, ntiles,
      n_new);
  return static_cast<int>(cudaGetLastError());
}
