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
// Bound: bytes.  The new mask is read once (one byte a lane); each new
// state's slot, origin, row, gid and ebits are read once, its row, parent
// and ebits written once at its slot and its queue entry once.  At the
// sharded paths' widths that is under a microsecond of memory time: what
// costs is latency, launches and how the rows' words are spread over the
// threads (a row copied word by word by one thread coalesces nowhere).
// Design: one launch.  Blocks of 256 threads take 256-lane tiles by ticket
// (in lane order, so a tile waits only on running tiles), rank their new
// lanes with a block scan (lane order), publish the tile's count and take
// its queue offset from a warp's decoupled look-back over the earlier
// tiles' epoch-tagged status words (sr::warp_look_back, K26's).  The new
// lanes' source row and slot are staged in shared memory; parent, ebits
// and the queue entry are written a thread a lane, and the rows by the
// whole block as flattened words -- consecutive threads on consecutive
// words of a row, eight words in flight a thread -- so a row is read and
// written in runs.  The last tile writes n_new.  The ticket and status
// words live in a scratch the wrapper keeps per card and stream (shared
// with K26); the last ticket of a call opens the next epoch.
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
constexpr int kCopyWords = 8;  // row words in flight a thread

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

// scratch: the ticket word ((epoch << 32) | tickets drawn), two words
// K26 keeps, then a status word a tile.
__global__ void __launch_bounds__(kThreads) commit_kernel(
    const uint8_t* __restrict__ is_new, int64_t r,
    const uint32_t* __restrict__ slot, const uint32_t* __restrict__ origin,
    const uint32_t* __restrict__ rows, int64_t row_stride, int w,
    const uint32_t* __restrict__ gid, int64_t gid_stride,
    const uint32_t* __restrict__ eb, int64_t eb_stride,
    uint32_t* __restrict__ store, uint32_t* __restrict__ parent,
    uint32_t* __restrict__ ebits, uint32_t* __restrict__ queue, int64_t qlen,
    int64_t tail, int64_t ntiles, int64_t* __restrict__ n_new,
    unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long s_ticket;
  __shared__ uint32_t s_before;  // new lanes in the tiles before this one
  __shared__ uint32_t s_src[kThreads];
  __shared__ uint32_t s_slot[kThreads];
  if (threadIdx.x == 0) {
    // The last ticket of the call opens the next epoch (every block has
    // drawn by then).
    const unsigned long long old = atomicAdd(scratch, 1ull);
    if (static_cast<uint32_t>(old) == gridDim.x - 1)
      atomicExch(scratch, ((old >> 32) + 1) << 32);
    s_ticket = old;
  }
  __syncthreads();
  const uint32_t epoch = static_cast<uint32_t>(s_ticket >> 32);
  const int64_t tile = static_cast<uint32_t>(s_ticket);
  unsigned long long* status = scratch + 3;

  const int64_t i = tile * kThreads + threadIdx.x;
  const bool keep = i < r && is_new[i];
  uint32_t count;
  const uint32_t rank =
      sr::block_exclusive_scan<kThreads, uint32_t>(keep ? 1u : 0u, &count);
  if (threadIdx.x < 32) {
    uint32_t before = 0;
    if (tile == 0) {
      if (threadIdx.x == 0)
        sr::store_status(status, sr::status_word(sr::kInclusive, epoch, count));
    } else {
      if (threadIdx.x == 0)
        sr::store_status(status + tile,
                         sr::status_word(sr::kAggregate, epoch, count));
      before = sr::warp_look_back(status, tile, 1, 0, epoch);
      if (threadIdx.x == 0)
        sr::store_status(status + tile,
                         sr::status_word(sr::kInclusive, epoch, before + count));
    }
    if (threadIdx.x == 0) s_before = before;
  }
  if (keep) {
    s_src[rank] = origin != nullptr ? origin[i] : static_cast<uint32_t>(i);
    s_slot[rank] = slot[i];
  }
  __syncthreads();
  const int64_t first = tail + s_before;  // this tile's first queue position
  if (tile == ntiles - 1 && threadIdx.x == 0)
    *n_new = static_cast<int64_t>(s_before) + count;

  if (threadIdx.x < count) {
    const uint32_t s = s_slot[threadIdx.x];
    const int64_t src = s_src[threadIdx.x];
    parent[s] = gid[src * gid_stride];
    ebits[s] = eb[src * eb_stride];
    const int64_t pos = first + threadIdx.x;
    if (pos < qlen) queue[pos] = s;
  }
  const uint32_t words = count * static_cast<uint32_t>(w);
  for (uint32_t f0 = threadIdx.x; f0 < words; f0 += kCopyWords * kThreads) {
    uint32_t val[kCopyWords];
    int64_t dst[kCopyWords];
#pragma unroll
    for (int q = 0; q < kCopyWords; ++q) {
      const uint32_t f = f0 + q * kThreads;
      dst[q] = -1;
      if (f >= words) continue;
      const uint32_t j = f / static_cast<uint32_t>(w);
      const uint32_t c = f - j * static_cast<uint32_t>(w);
      val[q] = __ldg(rows + static_cast<int64_t>(s_src[j]) * row_stride + c);
      dst[q] = static_cast<int64_t>(s_slot[j]) * w + c;
    }
#pragma unroll
    for (int q = 0; q < kCopyWords; ++q) {
      if (dst[q] >= 0) store[dst[q]] = val[q];
    }
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
// int64; scratch: at least 3 + max(1, ceil(r / 256)) 64-bit words, zeroed
// before its first call and then kept (the calls that share it must not
// overlap).
extern "C" int sr_shard_commit(const uint8_t* is_new, int64_t r,
                               const uint32_t* slot, const uint32_t* origin,
                               const uint32_t* rows, int64_t row_stride, int w,
                               const uint32_t* gid, int64_t gid_stride,
                               const uint32_t* eb, int64_t eb_stride,
                               uint32_t* store, uint32_t* parent,
                               uint32_t* ebits, uint32_t* queue, int64_t qlen,
                               int64_t tail, int64_t* n_new,
                               unsigned long long* scratch,
                               cudaStream_t stream) {
  int64_t ntiles = (r + kThreads - 1) / kThreads;
  if (ntiles < 1) ntiles = 1;  // r = 0: one empty tile writes n_new
  commit_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
      is_new, r, slot, origin, rows, row_stride, w, gid, gid_stride, eb,
      eb_stride, store, parent, ebits, queue, qlen, tail, ntiles, n_new,
      scratch);
  return static_cast<int>(cudaGetLastError());
}
