// K3: stable stream compaction.
//
// Replaces stateright_tpu/parallel/wave_common.py:267 compact (the
// cumsum + drop-mode scatter under hashset.py:174 compact_valid_indices and
// :195 compact_valid): out[j] = i for the j-th set lane i of mask, in lane
// order, for j < size; lanes past size are dropped and the caller compares
// the returned count (all set lanes) with size -- the overflow contract of
// hashset.py:206-217 (exactly full at count == size, tripped at size + 1).
// Every call on the path compacts lane indices (the JAX callers pass
// arange), so no values array is read.
//
// Bound: bytes.  The mask is read twice (one byte a lane) and each kept
// index written once; the scan is a few operations per lane.
// Design: three launches.  (1) each block counts the set lanes of one tile
// of 2048; (2) one block scans the tile counts into 64-bit tile offsets and
// the total; (3) each block re-reads its tile, scans the per-thread counts
// across the block with warp shuffles, and scatters its kept lanes from
// the tile offset on.  Each thread owns 8 consecutive lanes, so order is
// preserved within a thread, across threads by the block scan and across
// tiles by the offsets: the compaction is stable, which the row log needs
// (lane order decides BFS position).  Offsets are 64-bit.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void tile_count_kernel(const uint8_t* __restrict__ mask, int64_t n,
                                  int64_t* __restrict__ tile_counts) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i < n && mask[i]) ++c;
  }
  uint32_t total;
  sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void tile_scatter_kernel(const uint8_t* __restrict__ mask,
                                    int64_t n,
                                    const int64_t* __restrict__ tile_offsets,
                                    uint32_t* __restrict__ out, int64_t size) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool keep[kItems];
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    keep[k] = i < n && mask[i];
    c += keep[k] ? 1u : 0u;
  }
  uint32_t total;
  const uint32_t prefix = sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
  int64_t pos = tile_offsets[blockIdx.x] + prefix;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (keep[k]) {
      if (pos < size) out[pos] = static_cast<uint32_t>(base + k);
      ++pos;
    }
  }
}

}  // namespace

// mask: n bytes (0/1); out: size words, pre-filled by the caller;
// tile_scratch: ceil(n/2048) int64 words; count: one int64.
extern "C" int sr_compact(const uint8_t* mask, int64_t n, uint32_t* out,
                          int64_t size, int64_t* tile_scratch, int64_t* count,
                          cudaStream_t stream) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles > 0) {
    tile_count_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0, stream>>>(
        mask, n, tile_scratch);
  }
  sr::offsets_scan_kernel<<<1, sr::kScanThreads, 0, stream>>>(
      tile_scratch, ntiles, count);
  if (ntiles > 0) {
    tile_scatter_kernel<<<static_cast<unsigned>(ntiles), kThreads, 0,
                          stream>>>(mask, n, tile_scratch, out, size);
  }
  return static_cast<int>(cudaGetLastError());
}
