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
// Bound: bytes.  Each lane's key and validity are read once, each
// representative's index words and payload (row, gid, ebits) once, and
// the send buffer is written once.  At the sharded paths' widths (10^4 to
// 10^5 lanes, a 0.7-5 MB buffer) that is a microsecond or two of memory
// time; what costs is spreading the work over the card in one launch.
// Design: one launch, a multisplit (Ashkiani et al., PPoPP 2016) with a
// decoupled look-back.  Blocks of 256 threads take tiles of 256, 512 or
// 1,024 lanes (1, 2 or 4 a thread; the fewest that keep the tiles within
// two blocks an SM, so 32,768 lanes make 128 tiles) from an atomic ticket
// counter, in lane order, so a tile only ever waits on tiles already
// running.  A tile ranks its lanes within each warp with __match_any_sync
// on the owner and __popc of the lower lanes' mask (rank order (warp,
// item, lane) is lane order), sums the warps' per-owner counts in shared
// memory, publishes each owner's tile count in a 64-bit status word
// (flag, a per-call epoch and the count, read with one load), and takes
// each owner's offset from a warp-wide look-back over the earlier tiles'
// words, 128 at a time.  It then lists its representatives in (owner,
// rank) order in shared memory -- each one's slot, row index and parent --
// and the whole block copies their W + 3 words: consecutive threads move
// consecutive words of a row, and consecutive representatives of one
// owner land in consecutive slots, so reads come in row-long runs and
// writes in bucket-long ones.  The last tile writes the counts and the
// overflow word.
// Helper blocks draw the tickets after every tile's.  They wait for the
// last tile's inclusive words (the bucket sizes), then zero the buckets'
// tails [count, bkt), which no tile writes, in 2,048-word units, 16 bytes
// a store, with bucket and slot bounds computed once a unit (no per-word
// division); a memset of the whole buffer first would write the
// representatives' slots twice and cost a second operation on the stream.
// Where a full tile carries more payload than its block moves in two
// rounds (paxos rows of 45 words), the helpers also do the copy: a sorted
// sender's representatives are the first lanes, so 44 of sh-paxos3's 128
// tiles hold them all, and a copy by the tiles would sit on 44 SMs.  Each
// tile then writes its list to the scratch at the count of valid lanes
// before it, and the helpers copy even shares of the whole list once every
// tile has written its own; with light tiles the tiles copy, as the wait
// would cost more than it spreads.
// The status words are never cleared: the ticket word carries an epoch
// that the call's last ticket advances, and a word of another epoch reads
// as unpublished; the last block out of a helpers' copy zeroes the two
// counters it uses.  The wrapper keeps the scratch across calls.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // invalid or past u: no bucket
constexpr int64_t kZeroUnit = 2048;  // send words a helper warp zeroes at once
constexpr int kMaxHelpers = 2 * 132;
constexpr int kMaxTiles = 2 * 132;  // tiles above this take more lanes each
constexpr int kCopyWords = 8;       // payload words in flight a thread

__device__ __forceinline__ uint32_t owner_of(uint32_t hi, uint32_t lo,
                                             uint32_t n) {
  return sr::fmix32(lo ^ sr::rotl32(hi, 7) ^ 0xA511E9B3u) % n;
}

using sr::kAggregate;
using sr::kInclusive;
using sr::load_status;
using sr::published;
using sr::status_word;
using sr::store_status;
using sr::warp_look_back;

// Zero send words [lo, hi) with one warp: up to 3 words each side, 16
// bytes a store between (the buffer starts 16-byte aligned).
__device__ __forceinline__ void warp_zero(uint32_t* send, int64_t lo,
                                          int64_t hi, uint32_t lane) {
  if (lo >= hi) return;
  int64_t a = (lo + 3) & ~int64_t(3);
  if (a > hi) a = hi;
  int64_t b = hi & ~int64_t(3);
  if (b < a) b = a;
  if (lane < a - lo) send[lo + lane] = 0u;
  if (lane < hi - b) send[b + lane] = 0u;
  uint4* v = reinterpret_cast<uint4*>(send + a);
  const int64_t vecs = (b - a) >> 2;
  for (int64_t i = lane; i < vecs; i += 32) v[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Copy m listed representatives' payloads with the whole block: word f of
// the listed rows at thread f mod 256, kCopyWords words in flight a
// thread.  Consecutive threads move consecutive words of a row, and
// consecutive entries of one owner land in consecutive slots.
__device__ __forceinline__ void copy_listed(
    uint32_t m, uint32_t w, const uint32_t* __restrict__ rows,
    int64_t row_stride, const uint32_t* __restrict__ gids,
    const uint32_t* __restrict__ ebs, const long long* s_slot,
    const uint32_t* s_src, const uint32_t* s_par, uint32_t* __restrict__ send) {
  const uint32_t w3 = w + 3;
  const uint32_t words = m * w3;
  for (uint32_t f0 = threadIdx.x; f0 < words; f0 += kCopyWords * kThreads) {
    uint32_t val[kCopyWords];
    long long dst[kCopyWords];
#pragma unroll
    for (int q = 0; q < kCopyWords; ++q) {
      const uint32_t f = f0 + q * kThreads;
      dst[q] = -1;
      if (f >= words) continue;
      const uint32_t k = f / w3;
      const uint32_t c = f - k * w3;
      const long long slot = s_slot[k];
      if (slot < 0) continue;  // ranked past bkt: dropped
      dst[q] = slot * w3 + c;
      if (c < w) {
        val[q] = __ldg(rows + static_cast<int64_t>(s_src[k]) * row_stride + c);
      } else if (c == w) {
        val[q] = __ldg(gids + s_par[k]);
      } else if (c == w + 1) {
        val[q] = __ldg(ebs + s_par[k]);
      } else {
        val[q] = 1u;
      }
    }
#pragma unroll
    for (int q = 0; q < kCopyWords; ++q) {
      if (dst[q] >= 0) send[dst[q]] = val[q];
    }
  }
}

// A block leaves a call whose helpers copy; the last block out zeroes the
// tiles-listed and blocks-out words for the next such call on the stream
// (the tiles' own copy never touches them).
__device__ __forceinline__ void block_out(unsigned long long* scratch) {
  if (threadIdx.x == 0) {
    const unsigned long long out = atomicAdd(scratch + 2, 1ull);
    if (out == gridDim.x - 1) {
      scratch[1] = 0;
      scratch[2] = 0;
    }
  }
}

// The shared memory of a tile: each owner's offset in its bucket (then
// the totals, in a helper), its start in the tile's list, the warps'
// counts of it; then the list of the tile's representatives in (owner,
// rank) order: each one's slot, row index and parent.
__host__ __device__ constexpr size_t list_offset(uint32_t n) {
  return (size_t(n) * (4 + 4 + 2 * kWarps) + 15) & ~size_t(15);
}

template <int ITEMS>
constexpr size_t smem_bytes(uint32_t n) {
  return list_offset(n) + size_t(kThreads) * ITEMS * (8 + 4 + 4);
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads) bucket_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, int64_t u,
    const uint32_t* __restrict__ rows, int64_t row_stride, uint32_t w,
    const uint32_t* __restrict__ ridx, const uint32_t* __restrict__ olane,
    uint32_t a, const uint32_t* __restrict__ gids,
    const uint32_t* __restrict__ ebs, uint32_t n, int64_t bkt, int64_t ntiles,
    uint32_t* __restrict__ send, int64_t* __restrict__ counts,
    int* __restrict__ overflow, unsigned long long* __restrict__ scratch,
    bool helper_copy) {
  constexpr int kTile = kThreads * ITEMS;
  constexpr int kWarpItems = 32 * ITEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_off = reinterpret_cast<uint32_t*>(smem);   // [n]
  uint32_t* s_start = s_off + n;                          // [n]
  uint16_t* s_wc = reinterpret_cast<uint16_t*>(s_start + n);  // [kWarps][n]
  long long* s_slot = reinterpret_cast<long long*>(smem + list_offset(n));
  uint32_t* s_src = reinterpret_cast<uint32_t*>(s_slot + kTile);
  uint32_t* s_par = s_src + kTile;
  __shared__ unsigned long long s_ticket;

  // scratch: the ticket word, the tiles listed, the blocks out, then the
  // status words [ntiles][n], then the list of every tile's
  // representatives, two words each (slot; row index | parent << 32).
  unsigned long long* status = scratch + 3;
  unsigned long long* list = status + ntiles * n;
  if (threadIdx.x == 0) {
    // scratch[0] = (epoch << 32) | tickets drawn; the last ticket of the
    // call opens the next epoch (every block has drawn by then).
    const unsigned long long old = atomicAdd(scratch, 1ull);
    if (static_cast<uint32_t>(old) == gridDim.x - 1)
      atomicExch(scratch, ((old >> 32) + 1) << 32);
    s_ticket = old;
  }
  __syncthreads();
  const uint32_t epoch = static_cast<uint32_t>(s_ticket >> 32);
  const int64_t tile = static_cast<uint32_t>(s_ticket);
  const uint32_t warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t w3 = w + 3;

  if (tile >= ntiles) {
    // A helper: the last tile's inclusive words are the bucket sizes.
    uint32_t listed_here = 0;
    for (uint32_t d = threadIdx.x; d < n; d += kThreads) {
      const unsigned long long* p = status + (ntiles - 1) * n + d;
      unsigned long long word = load_status(p);
      while (!(published(word, epoch) && (word & kInclusive))) {
        __nanosleep(64);
        word = load_status(p);
      }
      const uint32_t tot = static_cast<uint32_t>(word);
      s_off[d] = tot < bkt ? tot : static_cast<uint32_t>(bkt);
      listed_here += tot;
    }
    __syncthreads();
    const int64_t per_bucket = bkt * w3;
    const int64_t words = per_bucket * n;
    const int64_t units = (words + kZeroUnit - 1) / kZeroUnit;
    const int64_t helpers = gridDim.x - ntiles;
    for (int64_t q = (tile - ntiles) * kWarps + warp; q < units;
         q += helpers * kWarps) {
      const int64_t u0 = q * kZeroUnit;
      const int64_t u1 = u0 + kZeroUnit < words ? u0 + kZeroUnit : words;
      for (int64_t d = u0 / per_bucket; d * per_bucket < u1; ++d) {
        const int64_t t0 = d * per_bucket + static_cast<int64_t>(s_off[d]) * w3;
        const int64_t t1 = (d + 1) * per_bucket;
        warp_zero(send, t0 > u0 ? t0 : u0, t1 < u1 ? t1 : u1, lane);
      }
    }
    if (!helper_copy) return;
    // Then an even share of the list, once every tile has listed its own.
    uint32_t listed;  // the representatives of all tiles
    sr::block_exclusive_scan<kThreads, uint32_t>(listed_here, &listed);
    if (threadIdx.x == 0) {
      while (load_status(scratch + 1) < static_cast<unsigned long long>(ntiles))
        __nanosleep(64);
      __threadfence();
    }
    __syncthreads();
    const int64_t h = tile - ntiles;
    const int64_t e1 = listed * (h + 1) / helpers;
    for (int64_t e0 = listed * h / helpers; e0 < e1; e0 += kTile) {
      const uint32_t m = e1 - e0 < kTile ? static_cast<uint32_t>(e1 - e0) : kTile;
      for (uint32_t k = threadIdx.x; k < m; k += kThreads) {
        s_slot[k] = static_cast<long long>(__ldcg(list + 2 * (e0 + k)));
        const unsigned long long sp = __ldcg(list + 2 * (e0 + k) + 1);
        s_src[k] = static_cast<uint32_t>(sp);
        s_par[k] = static_cast<uint32_t>(sp >> 32);
      }
      __syncthreads();
      copy_listed(m, w, rows, row_stride, gids, ebs, s_slot, s_src, s_par, send);
      __syncthreads();
    }
    block_out(scratch);
    return;
  }

  // Rank each lane within its warp among the lanes of its owner.
  for (uint32_t i = threadIdx.x; i < kWarps * n; i += kThreads) s_wc[i] = 0;
  __syncthreads();
  uint16_t* wc = s_wc + warp * n;
  const int64_t seg = tile * kTile + warp * kWarpItems;
  const unsigned below = (1u << lane) - 1u;
  uint32_t dest[ITEMS];
  uint32_t rank[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = seg + k * 32 + lane;
    dest[k] = (i < u && valid[i]) ? owner_of(hi[i], lo[i], n) : kNone;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, dest[k]);
    const uint32_t seen = dest[k] != kNone ? wc[dest[k]] : 0u;
    rank[k] = seen + __popc(peers & below);
    __syncwarp();
    if (dest[k] != kNone && lane == static_cast<uint32_t>(__ffs(peers) - 1))
      wc[dest[k]] = static_cast<uint16_t>(seen + __popc(peers));
    __syncwarp();
  }
  __syncthreads();

  // The warps' counts become exclusive prefixes over the warps; publish
  // each owner's tile count (tile 0's is already its inclusive prefix).
  for (uint32_t d = threadIdx.x; d < n; d += kThreads) {
    uint32_t run = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = s_wc[v * n + d];
      s_wc[v * n + d] = static_cast<uint16_t>(run);
      run += c;
    }
    s_start[d] = run;
    store_status(status + tile * n + d,
                 status_word(tile == 0 ? kInclusive : kAggregate, epoch, run));
  }
  __syncthreads();

  // Each owner's offset in its bucket: a warp's look-back an owner.
  for (uint32_t d = warp; d < n; d += kWarps) {
    uint32_t excl = 0;
    if (tile > 0) {
      excl = warp_look_back(status, tile, n, d, epoch);
      if (lane == 0)
        store_status(status + tile * n + d,
                     status_word(kInclusive, epoch, excl + s_start[d]));
    }
    if (lane == 0) s_off[d] = excl;
  }
  __syncthreads();

  if (tile == ntiles - 1) {
    // The last tile: the bucket sizes, the invalid lanes, the overflow bit.
    uint32_t sum = 0;
    int over = 0;
    for (uint32_t d = threadIdx.x; d < n; d += kThreads) {
      const uint32_t tot = s_off[d] + s_start[d];
      counts[d] = tot;
      sum += tot;
      over |= tot > bkt ? 1 : 0;
    }
    over = __syncthreads_or(over);
    uint32_t all;
    sr::block_exclusive_scan<kThreads, uint32_t>(sum, &all);
    if (threadIdx.x == 0) {
      counts[n] = u - static_cast<int64_t>(all);
      *overflow = over;
    }
    __syncthreads();
  }

  // Each owner's start in the tile's list: a scan of the tile counts, a
  // run of consecutive owners a thread.
  const uint32_t per = (n + kThreads - 1) / kThreads;
  const uint32_t d0 = threadIdx.x * per < n ? threadIdx.x * per : n;
  const uint32_t d1 = d0 + per < n ? d0 + per : n;
  uint32_t run = 0;
  for (uint32_t d = d0; d < d1; ++d) run += s_start[d];
  uint32_t listed;
  run = sr::block_exclusive_scan<kThreads, uint32_t>(run, &listed);
  for (uint32_t d = d0; d < d1; ++d) {
    const uint32_t c = s_start[d];
    s_start[d] = run;
    run += c;
  }
  __syncthreads();

  // List the representatives in (owner, rank) order.
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (dest[k] == kNone) continue;
    const uint32_t d = dest[k];
    const uint32_t within = s_wc[warp * n + d] + rank[k];
    const uint32_t p = s_start[d] + within;
    const int64_t r = static_cast<int64_t>(s_off[d]) + within;
    const int64_t i = seg + k * 32 + lane;
    s_slot[p] = r < bkt ? static_cast<long long>(d) * bkt + r : -1ll;
    s_src[p] = ridx[i];
    s_par[p] = olane[i] / a;
  }
  __syncthreads();

  if (!helper_copy) {
    copy_listed(listed, w, rows, row_stride, gids, ebs, s_slot, s_src, s_par, send);
    return;
  }
  // This tile's place in the whole list is the count of valid lanes in
  // the tiles before it; the helpers copy the list once every tile is in.
  uint32_t before = 0;
  for (uint32_t d = d0; d < d1; ++d) before += s_off[d];
  uint32_t base;
  sr::block_exclusive_scan<kThreads, uint32_t>(before, &base);
  for (uint32_t p = threadIdx.x; p < listed; p += kThreads) {
    list[2 * (static_cast<int64_t>(base) + p)] = static_cast<unsigned long long>(s_slot[p]);
    list[2 * (static_cast<int64_t>(base) + p) + 1] =
        s_src[p] | (static_cast<unsigned long long>(s_par[p]) << 32);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(scratch + 1, 1ull);
  block_out(scratch);
}

template <int ITEMS>
int launch(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
           int64_t u, const uint32_t* rows, int64_t row_stride, uint32_t w,
           const uint32_t* ridx, const uint32_t* olane, uint32_t a,
           const uint32_t* gids, const uint32_t* ebs, uint32_t n, int64_t bkt,
           uint32_t* send, int64_t* counts, int* overflow,
           unsigned long long* scratch, cudaStream_t stream) {
  constexpr int64_t kTile = kThreads * ITEMS;
  int64_t ntiles = (u + kTile - 1) / kTile;
  if (ntiles < 1) ntiles = 1;  // u = 0: one empty tile writes the counts
  const int64_t units = (static_cast<int64_t>(n) * bkt * (w + 3) + kZeroUnit - 1) /
                        kZeroUnit;
  // A tile copies its own representatives unless a full one would carry
  // more payload words than its threads move in two rounds; then the
  // helpers copy the whole list, a few thousand words each (a sorted
  // sender's representatives fill the first tiles, so the tiles' copy
  // would fall on a few SMs).
  const bool helper_copy = kTile * (w + 3) > kThreads * kCopyWords * 2;
  int64_t helpers = (units + kWarps - 1) / kWarps;
  if (helper_copy) {
    const int64_t copiers = (u * (w + 3) + kThreads * kCopyWords - 1) /
                            (kThreads * kCopyWords);
    if (helpers < copiers) helpers = copiers;
  }
  if (helpers > kMaxHelpers) helpers = kMaxHelpers;
  if (helpers < 1) helpers = 1;
  bucket_kernel<ITEMS><<<static_cast<unsigned>(ntiles + helpers), kThreads,
                         smem_bytes<ITEMS>(n), stream>>>(
      hi, lo, valid, u, rows, row_stride, w, ridx, olane, a, gids, ebs, n, bkt,
      ntiles, send, counts, overflow, scratch, helper_copy);
  return static_cast<int>(cudaGetLastError());
}

static_assert(smem_bytes<4>(1024) <= 48 * 1024, "no opt-in shared memory needed");

}  // namespace

// hi, lo: u key words; valid: u bytes; rows: 32-bit words, row r at
// rows + r * row_stride, w words each; ridx, olane: u words; gids, ebs:
// one word per state of the wave's chunk; send: n * bkt * (w + 3) words,
// 16-byte aligned; counts: n + 1 int64; overflow: one int; scratch: at
// least 3 + max(1, ceil(u / 256)) * n + 2 * u 64-bit words, zeroed before
// its first call and then kept (the calls that share it must not
// overlap).
// 1 <= n <= 1024, bkt >= 1, a >= 1, u < 2**31.
extern "C" int sr_owner_bucket(const uint32_t* hi, const uint32_t* lo,
                               const uint8_t* valid, int64_t u,
                               const uint32_t* rows, int64_t row_stride, int w,
                               const uint32_t* ridx, const uint32_t* olane,
                               int a, const uint32_t* gids, const uint32_t* ebs,
                               uint32_t n, int64_t bkt, uint32_t* send,
                               int64_t* counts, int* overflow,
                               unsigned long long* scratch,
                               cudaStream_t stream) {
  const uint32_t uw = static_cast<uint32_t>(w);
  const uint32_t ua = static_cast<uint32_t>(a);
  if ((u + 255) / 256 <= kMaxTiles)
    return launch<1>(hi, lo, valid, u, rows, row_stride, uw, ridx, olane, ua,
                     gids, ebs, n, bkt, send, counts, overflow, scratch, stream);
  if ((u + 511) / 512 <= kMaxTiles)
    return launch<2>(hi, lo, valid, u, rows, row_stride, uw, ridx, olane, ua,
                     gids, ebs, n, bkt, send, counts, overflow, scratch, stream);
  return launch<4>(hi, lo, valid, u, rows, row_stride, uw, ridx, olane, ua,
                   gids, ebs, n, bkt, send, counts, overflow, scratch, stream);
}
