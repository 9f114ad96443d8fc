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
//
// K28, the second entry (sr_shard_log_append): a tiered shard's append of
// the fresh lanes to its row log.  Replaces stateright_tpu/tiered/
// sharded_engine.py:289-302 (append_shard: the fresh-masked cumsum
// positions and the three drop-mode scatters).  For the j-th lane i with
// fresh[i], in lane order, with r = origin[i] (or i):
//   log_rows[tail + j]   = rows[r]      (w words)
//   log_parent[tail + j] = gid[r]
//   log_ebits[tail + j]  = eb[r]
// dropped where tail + j is past the log's end; n_fresh = the count of
// fresh lanes.
// Bound: bytes.  The fresh mask is read twice (one byte a lane); each fresh
// lane's origin, row, gid and ebits are read once and its log row, parent
// and ebits written once.
// Design: three launches over tiles of 256 lanes, one a thread, so the
// rows of a few thousand fresh lanes spread over tens of blocks: (1) each
// block counts its tile's fresh lanes; (2) one block turns the counts into
// each tile's first log offset and writes n_fresh; (3) each block ranks its
// lanes with a block scan (lane order), stages its fresh lanes' source
// indices in shared memory, then copies their rows with consecutive
// threads on consecutive words (a row's words are read and written by
// neighbouring threads, so both sides coalesce), and their parent and
// ebits words a thread a lane.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// K28's tile: one lane a thread, so a block copies the rows of 256 lanes
// at most and even a few thousand lanes spread over tens of blocks.
constexpr int kLogItems = 1;
constexpr int kLogTile = kThreads * kLogItems;

template <int ITEMS>
__global__ void tile_count_kernel(const uint8_t* __restrict__ is_new,
                                  int64_t r, int64_t* __restrict__ tile_counts) {
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x) * ITEMS;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
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

__global__ void log_append_kernel(const uint8_t* __restrict__ fresh, int64_t r,
                                  const uint32_t* __restrict__ origin,
                                  const uint32_t* __restrict__ rows,
                                  int64_t row_stride, int w,
                                  const uint32_t* __restrict__ gid,
                                  int64_t gid_stride,
                                  const uint32_t* __restrict__ eb,
                                  int64_t eb_stride,
                                  uint32_t* __restrict__ log_rows,
                                  uint32_t* __restrict__ log_parent,
                                  uint32_t* __restrict__ log_ebits,
                                  int64_t log_len, int64_t tail,
                                  const int64_t* __restrict__ tile_offsets) {
  __shared__ uint32_t src_lane[kLogTile];
  const int64_t offset = tile_offsets[blockIdx.x];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kLogTile + threadIdx.x * kLogItems;
  bool keep[kLogItems];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kLogItems; ++k) {
    const int64_t i = base + k;
    keep[k] = i < r && fresh[i];
    c += keep[k] ? 1u : 0u;
  }
  uint32_t count;
  uint32_t at = sr::block_exclusive_scan<kThreads, uint32_t>(c, &count);
#pragma unroll
  for (int k = 0; k < kLogItems; ++k) {
    if (!keep[k]) continue;
    const int64_t i = base + k;
    src_lane[at++] = origin != nullptr ? origin[i] : static_cast<uint32_t>(i);
  }
  __syncthreads();
  const int64_t first = tail + offset;  // this block's first log position
  const int64_t words = static_cast<int64_t>(count) * w;
  for (int64_t t = threadIdx.x; t < words; t += blockDim.x) {
    const int64_t j = t / w;
    const int64_t k = t - j * w;
    const int64_t pos = first + j;
    if (pos < log_len) {
      log_rows[pos * w + k] = rows[static_cast<int64_t>(src_lane[j]) * row_stride + k];
    }
  }
  for (int64_t j = threadIdx.x; j < count; j += blockDim.x) {
    const int64_t pos = first + j;
    if (pos >= log_len) continue;
    const int64_t src = src_lane[j];
    log_parent[pos] = gid[src * gid_stride];
    log_ebits[pos] = eb[src * eb_stride];
  }
}

}  // namespace

// fresh: r bytes; origin: r words or null; rows: row q at rows + q *
// row_stride, w words; gid, eb: word q at gid + q * gid_stride (eb
// likewise); log_rows: log_len * w words; log_parent, log_ebits: log_len
// words; n_fresh: one int64; tile_scratch: max(1, ceil(r / 256)) int64
// words.
extern "C" int sr_shard_log_append(const uint8_t* fresh, int64_t r,
                                   const uint32_t* origin, const uint32_t* rows,
                                   int64_t row_stride, int w,
                                   const uint32_t* gid, int64_t gid_stride,
                                   const uint32_t* eb, int64_t eb_stride,
                                   uint32_t* log_rows, uint32_t* log_parent,
                                   uint32_t* log_ebits, int64_t log_len,
                                   int64_t tail, int64_t* n_fresh,
                                   int64_t* tile_scratch, cudaStream_t stream) {
  int64_t ntiles = (r + kLogTile - 1) / kLogTile;
  if (ntiles < 1) ntiles = 1;
  tile_count_kernel<kLogItems>
      <<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(fresh, r,
                                                              tile_scratch);
  sr::offsets_scan_kernel<<<1, sr::kScanThreads, 0, stream>>>(
      tile_scratch, ntiles, n_fresh);
  log_append_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      fresh, r, origin, rows, row_stride, w, gid, gid_stride, eb, eb_stride,
      log_rows, log_parent, log_ebits, log_len, tail, tile_scratch);
  return static_cast<int>(cudaGetLastError());
}

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
  tile_count_kernel<kItems>
      <<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(is_new, r,
                                                              tile_scratch);
  commit_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      is_new, r, slot, origin, rows, row_stride, w, gid, gid_stride, eb,
      eb_stride, store, parent, ebits, queue, qlen, tail, tile_scratch, ntiles,
      n_new);
  return static_cast<int>(cudaGetLastError());
}
