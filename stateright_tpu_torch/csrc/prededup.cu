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
// Two entries share the kernels.  The mask entry sorts all n lanes, an
// inactive lane as the all-ones key.  The prefix entry sorts only the
// first m = min(*count, n) lanes, m read on the card (compact_valid's
// n_valid: on the sorted path the active lanes are that prefix), and
// writes rep 0 past m; keys and lanes past m are left unwritten.  Both
// give the same representatives in the same order: the all-ones lanes
// the mask entry adds sort after every other key and represent nothing.
//
// Bound: bytes.  The function reads each sorted lane's key once and
// writes its key and lane once (and a rep byte a buffer lane); the sort
// itself moves the 12-byte (key, lane) pair of each sorted lane in and
// out once a pass.  At the sorted path's widths (10^4 to 4 * 10^5 lanes)
// the buffers stay in the 50 MB L2 and the launches' fixed costs
// dominate: a pass costs a few microseconds whatever its width, so the
// design cuts launches (11 where the LSD sort it replaces made 26, three
// a pass, with one block scanning every pass's offsets) and sorts only
// the lanes that hold keys.
// Design: a one-sweep LSD radix sort (Onesweep) of 8-bit digits from
// the low digit up, 8 passes in two ping-pong buffers, in 11 launches
// (11-bit digits in 6 passes measured slower on the H100: 2,048 digits a
// tile to rank and look back over): (1) one upfront pass reads every key
// once and counts the digits of all passes at once, a shared histogram a
// block and a partial a block (it also zeroes the look-back words); (2)
// one block a pass sums the partials and scans them into each digit's
// global base; (3) one launch a digit pass: each block takes the next
// tile from an atomic tile counter (so every tile it looks back on is
// already running and the look-back cannot deadlock), holds kItems keys a
// thread in warp-striped order (a 2,048-lane tile of 512 threads, a shape
// chosen by timing several on the card at the paths' widths), ranks them
// within its warp with __match_any_sync (rank order is (warp, item,
// lane), which is lane order), sums the warps' digit counts, publishes
// each digit's tile count in a 64-bit status word (flag and count read
// with one load) and looks back over earlier tiles' words for its
// exclusive prefix -- decoupled look-back in place of a scan of all
// tiles' counts -- then stages the tile in shared memory in digit order
// and writes it out in coalesced runs.  The first pass reads hi, lo and
// the mask and makes the lane index itself; (4) one launch marks the
// representatives.  No library sort is used.
#include "sr_common.cuh"

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;        // 256
constexpr int kPasses = 64 / kBits;        // 8
constexpr int kThreads = 512;              // the first kDigits own a digit
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // keys a thread holds
constexpr int kWarpItems = 32 * kItems;    // a warp's segment of a tile
constexpr int kTile = kThreads * kItems;   // lanes a block sorts a pass
constexpr int kHistBlocks = 132;           // the upfront pass's grid cap
constexpr int kLookBack = 16;              // status words a look-back step reads
constexpr unsigned long long kOnes = ~0ull;
constexpr unsigned long long kAggregate = 1ull << 62;  // tile count only
constexpr unsigned long long kInclusive = 2ull << 62;  // prefix through it
constexpr unsigned long long kValue = (1ull << 62) - 1;
static_assert(kDigits <= kThreads, "a thread a digit");

// The pass kernel's shared memory: each digit's scatter offset (int64),
// its start within the tile (u32), then the warps' digit counts (u16),
// whose space the staged tile (keys, then lanes) reuses.
constexpr size_t kRankBytes = size_t(kWarps) * kDigits * 2;
constexpr size_t kStageBytes = size_t(kTile) * 12;
constexpr size_t kPassSmem =
    size_t(kDigits) * 12 + (kRankBytes > kStageBytes ? kRankBytes : kStageBytes);
constexpr size_t kHistSmem = size_t(kPasses) * kDigits * 4;
static_assert(kPassSmem <= 48 * 1024 && kHistSmem <= 48 * 1024,
              "no opt-in shared memory needed");

__device__ __forceinline__ int64_t sorted_count(const int64_t* count, int64_t n) {
  if (count == nullptr) return n;
  const int64_t m = *count;
  return m < 0 ? 0 : (m > n ? n : m);
}

__device__ __forceinline__ unsigned long long input_key(
    const uint32_t* hi, const uint32_t* lo, const uint8_t* active, int64_t i) {
  if (active != nullptr && !active[i]) return kOnes;
  return (static_cast<unsigned long long>(hi[i]) << 32) | lo[i];
}

__device__ __forceinline__ int digit_of(unsigned long long key, int pass) {
  return static_cast<int>((key >> (pass * kBits)) & (kDigits - 1));
}

// (1) Every pass's digit counts over the m sorted lanes, one partial a
// block: partial[block][pass][digit].  All-ones keys (the mask entry's
// inactive lanes) are counted apart and added once, so their one digit
// does not serialize the shared atomics.  Also zeroes the look-back
// words the passes will use and the tile counters.
__global__ void __launch_bounds__(kThreads) upfront_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint8_t* __restrict__ active, const int64_t* __restrict__ count,
    int64_t n, int64_t tiles_cap, uint32_t* __restrict__ partial,
    unsigned long long* __restrict__ status,
    unsigned int* __restrict__ tile_counter) {
  __shared__ uint32_t hist[kPasses * kDigits];
  const int64_t m = sorted_count(count, n);
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) hist[i] = 0;
  const int64_t tiles_m = (m + kTile - 1) / kTile;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t zero_words = static_cast<int64_t>(kPasses) * tiles_m * kDigits;
  for (int64_t i = gtid; i < zero_words; i += stride) {
    const int64_t pass = i / (tiles_m * kDigits);
    const int64_t rest = i - pass * tiles_m * kDigits;
    status[pass * tiles_cap * kDigits + rest] = 0;
  }
  if (gtid < kPasses) tile_counter[gtid] = 0;
  __syncthreads();
  uint32_t ones = 0;
  for (int64_t i = gtid; i < m; i += stride) {
    const unsigned long long key = input_key(hi, lo, active, i);
    if (key == kOnes) {
      ++ones;
      continue;
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      atomicAdd(&hist[p * kDigits + digit_of(key, p)], 1u);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) ones += __shfl_xor_sync(0xFFFFFFFFu, ones, d);
  if ((threadIdx.x & 31) == 0 && ones) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      atomicAdd(&hist[p * kDigits + digit_of(kOnes, p)], ones);
  }
  __syncthreads();
  uint32_t* out = partial + static_cast<int64_t>(blockIdx.x) * kPasses * kDigits;
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads) out[i] = hist[i];
}

// (2) One block a pass: sum the upfront partials of each digit and scan
// them into the digit's global base, base[pass][digit].
__global__ void __launch_bounds__(kThreads) base_kernel(
    const uint32_t* __restrict__ partial, int blocks,
    uint32_t* __restrict__ base) {
  const int pass = blockIdx.x;
  const int d = threadIdx.x;
  uint32_t c = 0;
  if (d < kDigits) {
    uint32_t s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const uint32_t* col = partial + pass * kDigits + d;
    int b = 0;
    for (; b + 8 <= blocks; b += 8) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        s[k] += col[static_cast<int64_t>(b + k) * kPasses * kDigits];
    }
    for (; b < blocks; ++b) s[0] += col[static_cast<int64_t>(b) * kPasses * kDigits];
    c = s[0] + s[1] + s[2] + s[3] + s[4] + s[5] + s[6] + s[7];
  }
  uint32_t total;
  const uint32_t run = sr::block_exclusive_scan<kThreads, uint32_t>(c, &total);
  if (d < kDigits) base[pass * kDigits + d] = run;
}

// The exclusive prefix of digit d over the tiles before `tile`: walk back
// over their status words, adding aggregates, until an inclusive prefix.
// The words of kLookBack tiles are read at once, so a walk over tiles
// that all started together (every tile but the first holding only its
// aggregate) costs a few dependent loads, not one a tile; a word not yet
// published is read again from there.
__device__ __forceinline__ unsigned long long look_back(
    const unsigned long long* status, int64_t tile, int d) {
  const volatile unsigned long long* col = status + d;
  unsigned long long excl = 0;
  int64_t j = tile - 1;  // the next tile to add
  for (;;) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int i = 0; i < kLookBack; ++i) w[i] = i <= j ? col[(j - i) * kDigits] : 0ull;
    int i = 0;
#pragma unroll
    for (; i < kLookBack; ++i) {
      if ((w[i] >> 62) == 0) break;  // not yet published (or past tile 0)
      excl += w[i] & kValue;
      if ((w[i] & kInclusive) != 0) return excl;
    }
    j -= i;
  }
}

// (3) One digit pass.  FIRST reads the input keys (hi, lo, the mask) and
// makes the lane index; the other passes read the previous pass's output.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads) pass_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint8_t* __restrict__ active,
    const unsigned long long* __restrict__ keys_in,
    const uint32_t* __restrict__ lanes_in, const int64_t* __restrict__ count,
    int64_t n, int pass, int64_t tiles_cap, const uint32_t* __restrict__ base,
    unsigned long long* __restrict__ status,
    unsigned int* __restrict__ tile_counter,
    unsigned long long* __restrict__ keys_out,
    uint32_t* __restrict__ lanes_out) {
  __shared__ __align__(16) unsigned char smem[kPassSmem];
  int64_t* s_delta = reinterpret_cast<int64_t*>(smem);                // [kDigits]
  uint32_t* s_start = reinterpret_cast<uint32_t*>(s_delta + kDigits);  // [kDigits]
  unsigned char* u = reinterpret_cast<unsigned char*>(s_start + kDigits);
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(u);  // [kWarps][kDigits]
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(u);
  uint32_t* s_lanes = reinterpret_cast<uint32_t*>(s_keys + kTile);
  __shared__ unsigned int s_tile;

  const int64_t m = sorted_count(count, n);
  if (threadIdx.x == 0) s_tile = atomicAdd(tile_counter + pass, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile_base = tile * kTile;
  if (tile_base >= m) return;  // past the sorted lanes: the whole block
  const int64_t tile_len = m - tile_base < kTile ? m - tile_base : kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint16_t* wr = s_rank + warp * kDigits;
  for (int d = lane; d < kDigits; d += 32) wr[d] = 0;
  __syncwarp();

  // Rank each key within its warp: the keys of one digit before it in
  // (item, lane) order, which is lane order within the warp's segment.
  unsigned long long key[kItems];
  uint32_t lane_ix[kItems];
  int dig[kItems];
  uint16_t rank[kItems];
  const unsigned below = (1u << lane) - 1u;
  const int64_t seg = tile_base + warp * kWarpItems;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = seg + k * 32 + lane;
    const bool live = i < m;
    if (FIRST) {
      key[k] = live ? input_key(hi, lo, active, i) : 0ull;
      lane_ix[k] = static_cast<uint32_t>(i);
    } else {
      key[k] = live ? keys_in[i] : 0ull;
      lane_ix[k] = live ? lanes_in[i] : 0u;
    }
    // Lanes past m form a group of their own (digit kDigits) and move
    // nothing.
    dig[k] = live ? digit_of(key[k], pass) : kDigits;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, dig[k]);
    const uint16_t seen = live ? wr[dig[k]] : 0;
    rank[k] = static_cast<uint16_t>(seen + __popc(peers & below));
    __syncwarp();
    if (live && lane == __ffs(peers) - 1)
      wr[dig[k]] = static_cast<uint16_t>(seen + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // Thread d owns digit d: the warps' counts become exclusive prefixes
  // over the warps, the tile's counts scan into each digit's start within
  // the tile.
  const int d = threadIdx.x;
  const bool owner = d < kDigits;
  uint32_t tcount = 0;
  if (owner) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = s_rank[w * kDigits + d];
      s_rank[w * kDigits + d] = static_cast<uint16_t>(tcount);
      tcount += c;
    }
  }
  uint32_t tile_total;
  const uint32_t start = sr::block_exclusive_scan<kThreads, uint32_t>(tcount, &tile_total);

  // Decoupled look-back: publish the digit's tile count, then find the
  // count of that digit in all earlier tiles.
  if (owner) {
    unsigned long long* st = status + static_cast<int64_t>(pass) * tiles_cap * kDigits;
    volatile unsigned long long* mine = st + tile * kDigits;
    mine[d] = (tile == 0 ? kInclusive : kAggregate) | tcount;
    unsigned long long excl = 0;
    if (tile > 0) {
      excl = look_back(st, tile, d);
      mine[d] = kInclusive | (excl + tcount);
    }
    s_start[d] = start;
    s_delta[d] = static_cast<int64_t>(base[pass * kDigits + d]) +
                 static_cast<int64_t>(excl) - static_cast<int64_t>(start);
  }
  __syncthreads();

  // Each key's place in the tile's digit order; then the ranks' space
  // takes the staged tile.
  uint32_t pos[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    pos[k] = dig[k] < kDigits
                 ? s_start[dig[k]] + s_rank[warp * kDigits + dig[k]] + rank[k]
                 : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (dig[k] < kDigits) {
      s_keys[pos[k]] = key[k];
      s_lanes[pos[k]] = lane_ix[k];
    }
  }
  __syncthreads();
  // Out in digit order: consecutive staged keys of a digit go to
  // consecutive slots, so the writes come in coalesced runs.
  for (int p = threadIdx.x; p < tile_len; p += kThreads) {
    const unsigned long long k = s_keys[p];
    const int64_t dst = s_delta[digit_of(k, pass)] + p;
    keys_out[dst] = k;
    lanes_out[dst] = s_lanes[p];
  }
}

// (4) The representatives of the sorted keys; 0 past the sorted lanes.
__global__ void rep_kernel(const unsigned long long* __restrict__ keys,
                           const int64_t* __restrict__ count, int64_t n,
                           uint8_t* __restrict__ rep) {
  const int64_t m = sorted_count(count, n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (i >= m) {
      rep[i] = 0;
      continue;
    }
    const unsigned long long k = keys[i];
    rep[i] = (k != kOnes && (i == 0 || keys[i - 1] != k)) ? 1 : 0;
  }
}

inline int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

inline int hist_blocks(int64_t n) {
  const int64_t t = tiles_for(n);
  return static_cast<int>(t < kHistBlocks ? t : kHistBlocks);
}

}  // namespace

// The scratch bytes sr_prededup_sort needs for n lanes: the look-back
// words (8 bytes a pass, tile and digit), the tile counters (8 bytes a
// pass), the upfront partials and the bases.
extern "C" int64_t sr_prededup_scratch_bytes(int64_t n) {
  return int64_t(kPasses) * tiles_for(n) * kDigits * 8 + int64_t(kPasses) * 8 +
         int64_t(hist_blocks(n)) * kPasses * kDigits * 4 +
         int64_t(kPasses) * kDigits * 4;
}

// hi, lo: n key words; active: n bytes (the mask entry) or null (the
// prefix entry, which sorts the first min(*count, n) lanes; count null
// sorts all n).  keys, keys_tmp: n 64-bit words; lanes, lanes_tmp: n
// words; scratch: sr_prededup_scratch_bytes(n) bytes.  Writes keys/lanes
// in sorted order (the mask entry's inactive lanes last, as the all-ones
// key) and rep: n bytes, the sorted lanes that represent a key.
extern "C" int sr_prededup_sort(const uint32_t* hi, const uint32_t* lo,
                                const uint8_t* active, const int64_t* count,
                                int64_t n, unsigned long long* keys,
                                unsigned long long* keys_tmp, uint32_t* lanes,
                                uint32_t* lanes_tmp, unsigned char* scratch,
                                uint8_t* rep, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t tiles = tiles_for(n);
  const int blocks = hist_blocks(n);
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  auto* counters = reinterpret_cast<unsigned int*>(status + int64_t(kPasses) * tiles * kDigits);
  auto* partial = counters + 2 * kPasses;
  uint32_t* base = partial + int64_t(blocks) * kPasses * kDigits;
  upfront_kernel<<<blocks, kThreads, 0, stream>>>(hi, lo, active, count, n, tiles,
                                                  partial, status, counters);
  base_kernel<<<kPasses, kThreads, 0, stream>>>(partial, blocks, base);
  // An even pass count ends in keys/lanes: pass 0 writes the spare buffer.
  static_assert(kPasses % 2 == 0, "the last pass writes keys/lanes");
  unsigned long long* in_k = keys;
  unsigned long long* out_k = keys_tmp;
  uint32_t* in_l = lanes;
  uint32_t* out_l = lanes_tmp;
  const unsigned grid = static_cast<unsigned>(tiles);
  pass_kernel<true><<<grid, kThreads, 0, stream>>>(
      hi, lo, active, nullptr, nullptr, count, n, 0, tiles, base, status,
      counters, out_k, out_l);
  for (int pass = 1; pass < kPasses; ++pass) {
    unsigned long long* tk = in_k;
    in_k = out_k;
    out_k = tk;
    uint32_t* tl = in_l;
    in_l = out_l;
    out_l = tl;
    pass_kernel<false><<<grid, kThreads, 0, stream>>>(
        nullptr, nullptr, nullptr, in_k, in_l, count, n, pass, tiles, base,
        status, counters, out_k, out_l);
  }
  rep_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(keys, count, n, rep);
  return static_cast<int>(cudaGetLastError());
}
